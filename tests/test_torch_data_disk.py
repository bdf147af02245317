"""The port's file-backed data vs the JAX package's.

- ``DomainSplit.from_csv`` bit for bit (values and dtypes) against the JAX
  package's on the cases of tests/test_native_loader.py: a plain file, CRLF
  line ends with float labels, a header-only file, an empty file and a
  malformed row (which the native parser refuses and numpy reads, in both
  packages); the native path taken for every file it accepts;
- the native parser against its plain version, numpy's (``load_csv_reference``);
- ``MultiDomainDataset.from_disk`` bit for bit against the JAX package's on a
  small Taobao tree (pretrained emb JSON; 12 domains, so ``domain_10`` sorts
  after ``domain_9``) and a small Amazon tree (no emb JSON,
  ``domain_property.json`` ctr ratios), ``dataset_info`` equal;
- ``_load_pretrained_emb`` bit for bit, rows the JSON omits zero;
- ``workload.write_domain_tree`` round-trips a dataset bit for bit;
- a native loader that cannot be built raises instead of parsing with numpy.
"""

import json
import os
import warnings

import numpy as np
import pytest

from mamdr_tpu.config import ExperimentConfig as JConfig
from mamdr_tpu.data import dataset as jdataset
from mamdr_tpu_torch.config import ExperimentConfig
from mamdr_tpu_torch.data import dataset, native_loader
from mamdr_tpu_torch.data.dataset import DomainSplit, MultiDomainDataset
from mamdr_tpu_torch.data.synthetic import make_synthetic_dataset
from mamdr_tpu_torch.workload import write_domain_tree

COLS = ("uid", "pid", "domain", "label")


def write_rows(path, n, rng, crlf=False):
    end = "\r\n" if crlf else "\n"
    uid, pid = rng.integers(0, 10000, n), rng.integers(0, 10000, n)
    dom, label = rng.integers(0, 30, n), rng.integers(0, 2, n)
    with open(path, "w", newline="") as f:
        f.write("uid,pid,domain,label" + end)
        for i in range(n):
            f.write(f"{uid[i]},{pid[i]},{dom[i]},{label[i]}{end}")


CSV_CASES = {
    "plain": None,
    "crlf_float_labels": "uid,pid,domain,label\r\n1,2,0,0.5\r\n3,4,1,1\n5,6,2,0.25\r\n",
    "header_only": "uid,pid,domain,label\n",
    "empty": "",
    "malformed": "uid,pid,domain,label\n1,notanint,0,1\n2,3,4,0\n",
    "no_trailing_newline": "uid,pid,domain,label\n7,8,9,1",
}


def splits_equal(a, b):
    for c in COLS:
        x, y = getattr(a, c), getattr(b, c)
        assert x.dtype == y.dtype and x.shape == y.shape, c
        np.testing.assert_array_equal(x, y, err_msg=c)


@pytest.mark.parametrize("case", sorted(CSV_CASES))
def test_from_csv_bit_equal_to_jax(tmp_path, case):
    path = str(tmp_path / f"{case}.csv")
    if CSV_CASES[case] is None:
        write_rows(path, 3000, np.random.default_rng(0))
    else:
        with open(path, "w", newline="") as f:
            f.write(CSV_CASES[case])
    before = native_loader.load_csv_native.files
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # numpy's notes on the empty and malformed files
        got, want = DomainSplit.from_csv(path), jdataset.DomainSplit.from_csv(path)
    splits_equal(got, want)
    native = native_loader.load_csv_native.files - before
    assert native == (0 if case == "malformed" else 1)


@pytest.mark.parametrize("crlf", [False, True])
def test_native_parser_matches_its_plain_version(tmp_path, crlf):
    path = str(tmp_path / "d.csv")
    write_rows(path, 5000, np.random.default_rng(1), crlf)
    got = native_loader.load_csv_native(path)
    want = native_loader.load_csv_reference(path)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _dataset(n_domain, with_emb, long_tail):
    ds = make_synthetic_dataset(n_domain=n_domain, n_uid=40, n_pid=50, n_per_domain=200,
                                seed=5, long_tail=long_tail, batch_size=16)
    if with_emb:
        rng = np.random.default_rng(3)
        ds.user_emb = rng.normal(0, 0.1, (40, 6)).astype(np.float32)
        ds.item_emb = rng.normal(0, 0.1, (50, 6)).astype(np.float32)
    return ds


@pytest.mark.parametrize("name,n_domain", [("Taobao", 12), ("Amazon", 4)])
def test_from_disk_bit_equal_to_jax(tmp_path, name, n_domain):
    ds = _dataset(n_domain, name == "Taobao", long_tail=name == "Amazon")
    if name == "Amazon":
        ds.ctr_ratio = {0: 0.125, 2: 0.3}
    write_domain_tree(ds, str(tmp_path / "split_x"))
    conf = {"dataset": {"name": name, "dataset_path": str(tmp_path),
                        "domain_split_path": "split_x", "batch_size": 16, "seed": 9}}
    before = native_loader.load_csv_native.files
    got = MultiDomainDataset.from_disk(ExperimentConfig.from_dict(conf).dataset)
    assert native_loader.load_csv_native.files - before == 3 * n_domain
    want = jdataset.MultiDomainDataset.from_disk(JConfig.from_dict(conf).dataset)
    assert (got.n_uid, got.n_pid, got.n_domain, got.seed, got.batch_size) == (
        want.n_uid, want.n_pid, want.n_domain, want.seed, want.batch_size)
    assert got.dataset_info == want.dataset_info
    assert got.ctr_ratio == want.ctr_ratio == ds.ctr_ratio
    for mode in ("train", "val", "test"):
        for a, b, c in zip(getattr(got, mode), getattr(want, mode), getattr(ds, mode)):
            splits_equal(a, b)
            splits_equal(a, c)  # and the dataset that was written
    if name == "Taobao":
        for a, b, c in ((got.user_emb, want.user_emb, ds.user_emb),
                        (got.item_emb, want.item_emb, ds.item_emb)):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        # domain_* directories in the order of their integer suffix
        assert [int(s.domain[0]) for s in got.train] == list(range(n_domain))
    else:
        assert got.user_emb is None and want.user_emb is None


def test_load_pretrained_emb_bit_equal_to_jax(tmp_path):
    """Strings with more digits than float32 holds, parsed straight to
    float32 as the JAX package parses them; rows not in the JSON are zero."""
    rng = np.random.default_rng(4)
    vals = rng.normal(0, 1, (30, 5))
    path = str(tmp_path / "emb.json")
    with open(path, "w") as f:
        json.dump({str(i): " ".join(f"{v:.17g}" for v in row)
                   for i, row in enumerate(vals) if i % 7}, f)
    got = dataset._load_pretrained_emb(path, 32)
    want = jdataset._load_pretrained_emb(path, 32)
    assert got.dtype == want.dtype == np.float32 and got.shape == (32, 5)
    np.testing.assert_array_equal(got, want)
    assert not got[0].any() and not got[30:].any()


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """No silent numpy parse when the library cannot be built: a source that
    does not compile, and a compiler that is missing, both raise."""
    path = str(tmp_path / "d.csv")
    write_rows(path, 10, np.random.default_rng(2))
    bad = tmp_path / "csv_loader.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native_loader, "SOURCE", str(bad))
    with pytest.raises(RuntimeError, match="build failed"):
        DomainSplit.from_csv(path)
    monkeypatch.setattr(native_loader, "SOURCE", str(tmp_path / "other.cc"))
    (tmp_path / "other.cc").write_text("int x;\n")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot run"):
        DomainSplit.from_csv(path)
    assert not os.listdir(tmp_path / "build")  # nothing half-built left behind


def test_concat_matches_jax():
    ds = _dataset(2, False, False)
    jds = jdataset.DomainSplit(*(getattr(ds.train[0], c) for c in COLS))
    jother = jdataset.DomainSplit(*(getattr(ds.val[1], c) for c in COLS))
    splits_equal(ds.train[0].concat(ds.val[1]), jds.concat(jother))
