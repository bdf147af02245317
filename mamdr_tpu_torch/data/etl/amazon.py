"""Amazon MDR dataset builder (reference dataset/Amazon/*).

Counterpart of ``mamdr_tpu/data/etl/amazon.py`` in numpy and the standard
library. Parses 5-core category review files (gzipped JSON lines with
reviewerID / asin / overall — reference preprocess_data.py:14-24), remaps
ids through persistent ``RawId2Id`` maps shared across categories, and
splits each category into a domain with the common negative-sampling
recipe.

Nothing is fetched. The raw files are looked for under
``<raw_data_path>/<Category_Name>`` with the suffixes ``_5.json.gz`` (the
reference's name), ``.json.gz``, ``.jsonl``, ``.json`` or ``.csv`` (uid, pid,
score columns), then in a local mirror directory (``mirror_path`` or
``MAMDR_AMAZON_MIRROR``), from which ``get_raw_data.get_raw_data_path``
copies them into place. Where the JAX package would download, this raises
``FileNotFoundError``; ``python -m mamdr_tpu_torch.data.etl.get_raw_data``
fetches the files.

CLI: ``python -m mamdr_tpu_torch.data.etl.amazon --config config.json``
with the reference's split-config schema (categories, ctr_ratio /
ctr_ratio_range + random_range, train_val_test, seed, rebuild, *_path).
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import os.path as osp
import random
from typing import List, Optional

import numpy as np

from mamdr_tpu_torch.data.etl.common import Frame, RawId2Id, read_csv, split_domains, write_csv
from mamdr_tpu_torch.data.etl.get_raw_data import category_name_to_filename, get_raw_data_path


def _category_filename(category: str) -> str:
    return category.replace(", ", "_").replace(" ", "_")


def _from_mirror(category: str, raw_data_path: str, mirror_path: Optional[str]) -> str:
    """Copy the category's file from a local mirror directory to
    ``raw_data_path`` (``get_raw_data_path``); raises when there is no
    mirror or the file is not in it."""
    mirror_path = mirror_path or os.environ.get("MAMDR_AMAZON_MIRROR", "")
    if not mirror_path:
        raise FileNotFoundError(f"{category_name_to_filename(category)}: no local mirror "
                                "given, and nothing is downloaded")
    return get_raw_data_path(category, raw_data_path, mirror_path=mirror_path)


def _raw_path(category: str, raw_data_path: str, mirror_path=None) -> str:
    """The category's raw reviews on disk: the local file (reference name
    first, then bare extensions), else a copy from the local mirror. Raises
    ``FileNotFoundError`` with the JAX package's advice otherwise."""
    base = _category_filename(category)
    for suffix in ("_5.json.gz", ".json.gz", ".jsonl", ".json", ".csv"):
        p = osp.join(raw_data_path, base + suffix)
        if osp.exists(p):
            return p
    try:
        return _from_mirror(category, raw_data_path, mirror_path)
    except Exception as e:
        raise FileNotFoundError(
            f"raw reviews for {category!r} not found under {raw_data_path} "
            f"and could not be fetched ({e}) — place the 5-core category "
            f"file there, or set mirror_path/MAMDR_AMAZON_MIRROR to a local "
            f"mirror directory"
        ) from e


def _column(values: list) -> np.ndarray:
    """A column of JSON values typed as pandas types a column of python
    objects: int64, float64 when any is a float, else objects."""
    if all(isinstance(v, int) and not isinstance(v, bool) for v in values):
        return np.array(values, dtype=np.int64)
    if all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in values):
        return np.array(values, dtype=np.float64)
    return np.array(values, dtype=object)


def load_reviews(path: str) -> Frame:
    """-> frame {uid, pid, score} (raw ids)."""
    if path.endswith(".csv"):
        df = read_csv(path)
        if not {"uid", "pid", "score"} <= set(df):
            raise ValueError(f"{path}: the columns uid, pid and score are needed, not {list(df)}")
        return {k: df[k] for k in ("uid", "pid", "score")}
    opener = gzip.open if path.endswith(".gz") else open
    rows = []
    with opener(path, "rb") as f:
        for line in f:
            d = json.loads(line)
            rows.append([d["reviewerID"], d["asin"], d["overall"]])
    cols = list(zip(*rows)) if rows else [(), (), ()]
    return {k: _column(list(c)) for k, c in zip(("uid", "pid", "score"), cols)}


def preprocess(categories: List[str], processed_data_path: str, raw_data_path: str,
               rebuild: bool = False, mirror_path=None) -> List[str]:
    """Reviews -> per-category processed csv with persistent id maps
    (reference preprocess_data.py:27-63)."""
    uid2id_path = osp.join(processed_data_path, "uid2id.json")
    pid2id_path = osp.join(processed_data_path, "pid2id.json")
    uid2id = RawId2Id(uid2id_path, rebuild)
    pid2id = RawId2Id(pid2id_path, rebuild)
    old_u, old_p = uid2id.content_hash(), pid2id.content_hash()

    os.makedirs(processed_data_path, exist_ok=True)
    out = []
    for c in categories:
        processed = osp.join(processed_data_path, _category_filename(c) + ".csv")
        if not rebuild and osp.exists(processed):
            out.append(processed)
            continue
        df = load_reviews(_raw_path(c, raw_data_path, mirror_path))
        df["uid"] = np.array([uid2id.fit_transform(v) for v in df["uid"].tolist()], np.int64)
        df["pid"] = np.array([pid2id.fit_transform(v) for v in df["pid"].tolist()], np.int64)
        write_csv(processed, df, ["uid", "pid", "score"])
        out.append(processed)

    if uid2id.content_hash() != old_u:
        uid2id.export(uid2id_path)
    if pid2id.content_hash() != old_p:
        pid2id.export(pid2id_path)
    return out


def split_to_domains(conf: dict) -> int:
    split_save_path = conf["split_save_path"]
    processed_data_path = osp.join(split_save_path, conf["processed_data_path"])
    files = preprocess(conf["categories"], processed_data_path, conf["raw_data_path"],
                       rebuild=conf.get("rebuild", False),
                       mirror_path=conf.get("mirror_path"))
    n = split_domains(files, split_save_path, conf, rename_cols={"score": "score"})
    print(f"Split {n} domains at: {split_save_path}")
    return n


if __name__ == "__main__":
    parser = argparse.ArgumentParser(prog="python -m mamdr_tpu_torch.data.etl.amazon")
    parser.add_argument("--config", type=str, required=True)
    args = parser.parse_args()
    with open(args.config) as f:
        conf = json.load(f)
    random.seed(conf["seed"])
    split_to_domains(conf)
