"""The port's domain ETL (numpy and the standard library) vs the JAX
package's (pandas and sklearn), on the CPU: the building blocks on the same
inputs, then whole builds whose every output file must be byte-equal, on a
first and a second invocation (the on-disk shuffle re-runs every time).

- ``RawId2Id``; the two-stage split on frames of 1-50 rows with one label
  and with two (sklearn's ``StratifiedShuffleSplit`` reproduced), and
  ``_train_test_split`` against sklearn's ``train_test_split`` with three
  classes; both negative samplers; ``assign_user_splits``;
  ``shuffle_csv_file`` on ints, floats with a NaN, strings and a header-only
  file;
- the Taobao ETL (both samplers) and the Amazon ETL (gzipped JSON lines and
  a CSV input) on tiny raw files the tests write; the Amazon raw-file
  lookup (a local mirror; nothing fetched);
- ``get_raw_data`` against the JAX module, with no network: the filename
  contract, a mirror directory with and without the ``_5`` suffix (given or
  from ``MAMDR_AMAZON_MIRROR``), a ``file://`` base URL (given, from
  ``MAMDR_AMAZON_BASE_URL`` or on the CLI), a file already in place kept
  unless ``redownload``, and a missing file raising what the JAX one raises;
- ``generate_amazon_reviews``: the decompressed files equal (a gzip header
  carries a time);
- ``validate.build_raw`` and the Taobao ETL at the Taobao-10 recipe against
  ``scripts/validate_taobao10.py``'s ``build_raw`` / ``build_split`` (its
  ``ROOT`` set to the test's directory), then ``from_disk`` of the tree in
  both packages.
"""

import gzip
import importlib.util
import json
import os
import random

import numpy as np
import pandas as pd
import pytest
from sklearn.model_selection import train_test_split

from mamdr_tpu.config import DatasetConfig as JDatasetConfig
from mamdr_tpu.data import synthetic as jsynthetic
from mamdr_tpu.data.dataset import MultiDomainDataset as JDataset
from mamdr_tpu.data.etl import amazon as jamazon
from mamdr_tpu.data.etl import common as jcommon
from mamdr_tpu.data.etl import get_raw_data as jget_raw_data
from mamdr_tpu.data.etl import taobao as jtaobao
from mamdr_tpu_torch import validate
from mamdr_tpu_torch.data import synthetic
from mamdr_tpu_torch.data.etl import amazon, common, get_raw_data, taobao
from test_etl import _write_amazon_raw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def files_of(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def assert_same_tree(a, b):
    assert files_of(a) == files_of(b)
    for f in files_of(a):
        with open(os.path.join(a, f), "rb") as x, open(os.path.join(b, f), "rb") as y:
            assert x.read() == y.read(), f


def frame_rows(df):
    """A pandas frame or a port frame as a list of row tuples."""
    if isinstance(df, pd.DataFrame):
        return [tuple(r) for r in df.itertuples(index=False)]
    return list(zip(*(c.tolist() for c in df.values())))


def test_rawid2id_matches(tmp_path):
    ids = ["u3", 7, "u3", "x", 7.5, "7"]
    j, t = jcommon.RawId2Id(), common.RawId2Id()
    assert [t.fit_transform(v) for v in ids] == [j.fit_transform(v) for v in ids]
    j.export(str(tmp_path / "j" / "m.json"))
    t.export(str(tmp_path / "t" / "m.json"))
    assert (tmp_path / "j" / "m.json").read_bytes() == (tmp_path / "t" / "m.json").read_bytes()
    t2 = common.RawId2Id(str(tmp_path / "t" / "m.json"))
    assert (t2.id, t2.raw_id2id) == (j.id, j.raw_id2id)


@pytest.mark.parametrize("labels", ["one", "two"])
def test_split_matches_sklearn(labels):
    """Frames of 1-50 rows: the same rows in each part, in the same order,
    or the same error."""
    for n in range(1, 51):
        rng = np.random.default_rng(n)
        cols = {"uid": rng.integers(0, 9, n), "pid": rng.integers(0, 99, n),
                "domain": np.full(n, 2), "label": (np.ones(n, np.int64) if labels == "one"
                                                   else rng.integers(0, 2, n))}
        want = got = None
        try:
            want = jcommon.split_stratified_into_train_val_test(
                pd.DataFrame(cols), random_state=123)
        except ValueError as e:
            want = str(e)
        try:
            got = common.split_stratified_into_train_val_test(
                {k: np.asarray(v, np.int64) for k, v in cols.items()}, random_state=123)
        except ValueError as e:
            got = str(e)
        if isinstance(want, str):
            assert got == want, n
        else:
            assert [frame_rows(p) for p in got] == [frame_rows(p) for p in want], n


@pytest.mark.parametrize("seed", [0, 7])
def test_stratified_split_matches_train_test_split(seed):
    """Three classes of unequal counts, so _approximate_mode breaks ties."""
    y = np.repeat([0, 1, 2], [17, 9, 6])
    np.random.default_rng(seed).shuffle(y)
    for test_size in (0.4, 0.5, 0.25):
        tr, te = train_test_split(np.arange(len(y)), test_size=test_size, random_state=seed,
                                  stratify=y[:, None])
        got = common._train_test_split(len(y), test_size, seed, stratify=y)
        assert [list(got[0]), list(got[1])] == [list(tr), list(te)]


def _clicks(seed=3, n_users=40, n_items=30, n=300):
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({"uid": rng.integers(0, n_users, n), "pid": rng.integers(0, n_items, n),
                       "domain": 0}).drop_duplicates()
    return df, {k: df[k].to_numpy().astype(np.int64) for k in df.columns}


def test_negative_samplers_match():
    jdf, tdf = _clicks()
    pid_range = jdf["pid"].unique().tolist()
    for ctr in (0.3, 0.9):
        want = jcommon.sample_negatives_for_domain(jdf, pid_range, ctr, 4, random.Random(5))
        got = common.sample_negatives_for_domain(tdf, pid_range, ctr, 4, random.Random(5))
        assert frame_rows(got) == frame_rows(want[common.HEADER])
        want = jcommon.sample_negatives_vectorized(jdf, pid_range, ctr, 4,
                                                   np.random.default_rng(5))
        got = common.sample_negatives_vectorized(tdf, pid_range, ctr, 4,
                                                 np.random.default_rng(5))
        assert frame_rows(got) == frame_rows(want[common.HEADER])
    # dense users: the whole complement
    dense = {"uid": np.zeros(8, np.int64), "pid": np.arange(8), "domain": np.zeros(8, np.int64)}
    got = common.sample_negatives_vectorized(dense, list(range(10)), 0.2, 0,
                                             np.random.default_rng(0))
    want = jcommon.sample_negatives_vectorized(pd.DataFrame(dense), list(range(10)), 0.2, 0,
                                               np.random.default_rng(0))
    assert frame_rows(got) == frame_rows(want[common.HEADER]) and sorted(got["pid"]) == [8, 9]


def test_assign_user_splits_matches():
    uid = np.concatenate([np.full(m, i) for i, m in enumerate([1, 2, 3, 10, 37, 5])])
    np.random.default_rng(1).shuffle(uid)
    for fracs in ([0.6, 0.2, 0.2], [0.8, 0.1, 0.1]):
        assert np.array_equal(common.assign_user_splits(uid, fracs, np.random.default_rng(2)),
                              jcommon.assign_user_splits(uid, fracs, np.random.default_rng(2)))


def test_shuffle_csv_file_matches(tmp_path):
    body = ("a,b,c,d\r\n007,1.5,x y,3\r\n8,,\"q,r\",4\r\n-2,1e-05,z,5\r\n"
            "9,2.0,w,6\r\n11,3.25,v,7\r\n")
    for name, text in (("mixed.csv", body), ("empty.csv", "uid,pid,domain,label\r\n")):
        for side in ("j", "t"):
            (tmp_path / side).mkdir(exist_ok=True)
            (tmp_path / side / name).write_text(text, newline="")
        jcommon.shuffle_csv_file(str(tmp_path / "j" / name), 123)
        common.shuffle_csv_file(str(tmp_path / "t" / name), 123)
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()


def _taobao_raw(raw):
    rng = np.random.default_rng(3)
    raw.mkdir()
    for name, n in (("user", 120), ("item", 60)):
        ids = [f"{name[0]}{i}" for i in range(n)]
        pd.DataFrame({f"{name}_id": ids,
                      "emb": [" ".join(map(str, rng.normal(size=4).round(3))) for _ in ids]}
                     ).set_index(f"{name}_id").to_csv(raw / f"{name}_embedding.csv")
    rows = [{"user_id": f"u{rng.integers(0, 60)}", "item_id": f"i{rng.integers(0, 70)}",
             "theme_id": int(rng.integers(100, 104))} for _ in range(600)]
    rows += [{"user_id": f"u{60 + i}", "item_id": f"i{40 + (i % 20)}", "theme_id": 101}
             for i in range(50)]  # a starving theme of 1-click users
    pd.DataFrame(rows).to_csv(raw / "theme_click_log.csv", index=False)


@pytest.mark.parametrize("legacy", [False, True])
def test_taobao_etl_byte_equal(tmp_path, legacy):
    _taobao_raw(tmp_path / "raw")
    for side, mod in (("jax", jtaobao), ("port", taobao)):
        conf = {"raw_data_path": str(tmp_path / "raw"), "split_save_path": str(tmp_path / side),
                "processed_data_path": "processed_data", "theme_num": 3, "ctr_ratio": 0.4,
                "random_range": True, "ctr_ratio_range": [0.2, 0.5],
                "train_val_test": [0.6, 0.2, 0.2], "seed": 123, "rebuild": False,
                "legacy_negatives": legacy}
        assert mod.split_to_domains(conf) == 3
        if side == "port":
            assert_same_tree(tmp_path / "jax", tmp_path / "port")
    for side, mod in (("jax", jtaobao), ("port", taobao)):  # again: the shuffle re-runs
        conf["split_save_path"] = str(tmp_path / side)
        mod.split_to_domains(conf)
    assert_same_tree(tmp_path / "jax", tmp_path / "port")


@pytest.mark.parametrize("raw_format", ["json.gz", "csv"])
def test_amazon_etl_byte_equal(tmp_path, raw_format):
    cats, raw = _write_amazon_raw(tmp_path)
    if raw_format == "csv":  # uid, pid, score columns instead, mixed int / float scores
        for i, c in enumerate(cats):
            path = os.path.join(raw, c.replace(" ", "_") + ".json.gz")
            with gzip.open(path, "rt") as f:
                rows = [json.loads(line) for line in f]
            os.unlink(path)
            pd.DataFrame({"uid": [r["reviewerID"] for r in rows],
                          "pid": [r["asin"] for r in rows],
                          "score": [r["overall"] + 0.5 * (k % 3 == i) for k, r in enumerate(rows)]}
                         ).to_csv(path[:-len(".json.gz")] + ".csv", index=False)
    for _ in range(2):
        for side, mod in (("jax", jamazon), ("port", amazon)):
            conf = {"categories": cats, "raw_data_path": raw,
                    "split_save_path": str(tmp_path / side),
                    "processed_data_path": "processed_data", "ctr_ratio": 0.5,
                    "random_range": False, "ctr_ratio_range": [0.2, 0.5],
                    "train_val_test": [0.6, 0.2, 0.2], "seed": 123, "rebuild": False}
            assert mod.split_to_domains(conf) == 2
        assert_same_tree(tmp_path / "jax", tmp_path / "port")


def test_amazon_raw_lookup(tmp_path, monkeypatch):
    """A local file, then a copy from the local mirror; nothing fetched."""
    monkeypatch.delenv("MAMDR_AMAZON_MIRROR", raising=False)
    mirror, raw = tmp_path / "mirror", tmp_path / "raw"
    mirror.mkdir()
    with gzip.open(mirror / "Video_Games.json.gz", "wt") as f:
        f.write(json.dumps({"reviewerID": "u1", "asin": "i1", "overall": 5.0}) + "\n")
    with pytest.raises(FileNotFoundError, match="MAMDR_AMAZON_MIRROR"):
        amazon._raw_path("Video Games", str(raw))
    p = amazon._raw_path("Video Games", str(raw), mirror_path=str(mirror))
    assert p == str(raw / "Video_Games_5.json.gz") and os.path.exists(p)
    assert amazon._raw_path("Video Games", str(raw)) == p  # found locally now
    assert p == jamazon._raw_path("Video Games", str(raw))


CATEGORIES = ["Video Games", "Clothing, Shoes and Jewelry", "Toys_and_Games", "Books"]


@pytest.fixture
def no_fetch_env(monkeypatch):
    """Neither override taken from the environment unless a test sets it."""
    monkeypatch.delenv("MAMDR_AMAZON_MIRROR", raising=False)
    monkeypatch.delenv("MAMDR_AMAZON_BASE_URL", raising=False)
    return monkeypatch


def _fetched(tmp_path, side, **kw):
    """``get_raw_data_path`` of each package for "Video Games" into
    ``tmp_path/side``: (path relative to it, bytes)."""
    mod = {"jax": jget_raw_data, "port": get_raw_data}[side]
    target = tmp_path / side
    p = mod.get_raw_data_path("Video Games", str(target), **kw)
    with open(p, "rb") as f:
        return os.path.relpath(p, target), f.read()


@pytest.mark.parametrize("category", CATEGORIES)
def test_get_raw_data_filename_contract(category):
    assert (get_raw_data.category_name_to_filename(category)
            == jget_raw_data.category_name_to_filename(category))
    assert get_raw_data.DEFAULT_BASE_URL == jget_raw_data.DEFAULT_BASE_URL


@pytest.mark.parametrize("name,from_env", [("Video_Games_5.json.gz", False),
                                           ("Video_Games.json.gz", False),
                                           ("Video_Games.json.gz", True)])
def test_get_raw_data_from_mirror(tmp_path, no_fetch_env, name, from_env):
    mirror = tmp_path / "mirror"
    mirror.mkdir()
    (mirror / name).write_bytes(b"reviews of " + name.encode())
    kw = {"mirror_path": str(mirror)}
    if from_env:
        no_fetch_env.setenv("MAMDR_AMAZON_MIRROR", str(mirror))
        kw = {}
    got = _fetched(tmp_path, "port", **kw)
    assert got == _fetched(tmp_path, "jax", **kw)
    assert got == ("Video_Games_5.json.gz", b"reviews of " + name.encode())


@pytest.mark.parametrize("how", ["argument", "env", "cli"])
def test_get_raw_data_from_file_url(tmp_path, no_fetch_env, how):
    src = tmp_path / "served"
    src.mkdir()
    for c in ("Video Games", "Books"):
        (src / get_raw_data.category_name_to_filename(c)).write_bytes(c.encode() * 3)
    url = f"file://{src}/{{}}"
    if how == "cli":
        target = tmp_path / "port"
        assert get_raw_data.main(["--categories", "Video Games", "Books", "--target",
                                  str(target), "--base-url", url]) == 0
        assert files_of(target) == ["Books_5.json.gz", "Video_Games_5.json.gz"]
        assert (target / "Books_5.json.gz").read_bytes() == b"Books" * 3
        return
    kw = {"base_url": url}
    if how == "env":
        no_fetch_env.setenv("MAMDR_AMAZON_BASE_URL", url)
        kw = {}
    got = _fetched(tmp_path, "port", **kw)
    assert got == _fetched(tmp_path, "jax", **kw) == ("Video_Games_5.json.gz",
                                                      b"Video Games" * 3)
    assert files_of(tmp_path / "port") == ["Video_Games_5.json.gz"]  # no .part left


def test_get_raw_data_keeps_a_file_unless_redownload(tmp_path, no_fetch_env):
    mirror = tmp_path / "mirror"
    mirror.mkdir()
    (mirror / "Video_Games_5.json.gz").write_bytes(b"mirror")
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
        (tmp_path / side / "Video_Games_5.json.gz").write_bytes(b"old")
    for redownload, want in ((False, b"old"), (True, b"mirror")):
        kw = {"mirror_path": str(mirror), "redownload": redownload}
        got = _fetched(tmp_path, "port", **kw)
        assert got == _fetched(tmp_path, "jax", **kw) == ("Video_Games_5.json.gz", want)


@pytest.mark.parametrize("where", ["mirror", "url"])
def test_get_raw_data_missing_file_raises_as_jax(tmp_path, no_fetch_env, where):
    empty = tmp_path / "empty"
    empty.mkdir()
    kw = ({"mirror_path": str(empty)} if where == "mirror"
          else {"base_url": f"file://{empty}/{{}}"})
    errors = {}
    for side in ("jax", "port"):
        with pytest.raises((FileNotFoundError, RuntimeError)) as e:
            _fetched(tmp_path, side, **kw)
        errors[side] = (type(e.value), str(e.value).replace(str(tmp_path / side), "T"))
        assert files_of(tmp_path / side) == []  # nothing left behind
    assert errors["port"] == errors["jax"]
    assert errors["port"][0] is (FileNotFoundError if where == "mirror" else RuntimeError)


def test_generate_amazon_reviews_matches(tmp_path):
    kw = dict(sizes=[300, 120], items=[50, 30], n_users=80, seed=4)
    for dom_fn in ("tanh", "noise"):
        jd, td = tmp_path / f"j{dom_fn}", tmp_path / f"t{dom_fn}"
        jsynthetic.generate_amazon_reviews(str(jd), dom_fn=dom_fn, **kw)
        synthetic.generate_amazon_reviews(str(td), dom_fn=dom_fn, **kw)
        assert files_of(jd) == files_of(td) == ["Cat_0.json.gz", "Cat_1.json.gz"]
        for f in files_of(jd):
            with gzip.open(jd / f, "rb") as a, gzip.open(td / f, "rb") as b:
                assert a.read() == b.read(), f


def test_validation_recipe_byte_equal(tmp_path):
    """validate.build_raw and build_split at Taobao-10 against the JAX
    package's validation script, then from_disk of the tree in both."""
    spec = importlib.util.spec_from_file_location(
        "validate_taobao10", os.path.join(REPO, "scripts", "validate_taobao10.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    script.ROOT = str(tmp_path / "jax")
    script.build_split(script.build_raw())
    validate.build_split(validate.build_raw(str(tmp_path / "port"), "taobao10"),
                         str(tmp_path / "port"), "taobao10")
    assert_same_tree(tmp_path / "jax", tmp_path / "port")

    port = validate.load(str(tmp_path / "port"), "taobao10")
    jax_ds = JDataset.from_disk(JDatasetConfig(
        name="Taobao", dataset_path=str(tmp_path / "jax"),
        domain_split_path="split_by_theme_10", batch_size=1024, seed=123))
    assert (port.n_domain, port.n_uid, port.n_pid) == (jax_ds.n_domain, jax_ds.n_uid,
                                                       jax_ds.n_pid)
    assert port.n_domain == 10
    assert np.array_equal(port.user_emb, jax_ds.user_emb)
    assert np.array_equal(port.item_emb, jax_ds.item_emb)
    for mode in ("train", "val", "test"):
        for a, b in zip(getattr(port, mode), getattr(jax_ds, mode)):
            for k in ("uid", "pid", "domain", "label"):
                assert np.array_equal(getattr(a, k), getattr(b, k)), (mode, k)
    assert port.ctr_ratio == jax_ds.ctr_ratio
