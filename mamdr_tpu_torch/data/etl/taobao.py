"""Taobao theme-click dataset builder (reference dataset/Taobao/*).

Counterpart of ``mamdr_tpu/data/etl/taobao.py`` in numpy and the standard
library. Input (local files under ``raw_data_path``, the Tianchi
theme-click dataset's layout):

  theme_click_log.csv       columns incl. user_id, item_id, theme_id
  user_embedding.csv        index user_id -> space-separated 128-d vector
  item_embedding.csv        index item_id -> space-separated 128-d vector

Pipeline (reference preprocess_data.py:26-95): remap theme ids in order of
first appearance; keep only the clicks whose user and item have pretrained
embeddings; take the first ``theme_num`` themes (-1: all) as domains, each a
``processed_data/theme_<id>.csv`` of remapped user and item ids; export the
id maps and ``user_emb.json`` / ``item_emb.json`` keyed by the remapped int
id; then the common split recipe (positives are clicks, label 1).

CLI: ``python -m mamdr_tpu_torch.data.etl.taobao --config config.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import random
from typing import List

import numpy as np

from mamdr_tpu_torch.data.etl.common import (
    RawId2Id, group_rows, read_csv, split_domains, take, write_csv)


def _embedding_dict(path: str) -> dict:
    """{index: vector} of an embedding CSV whose first column is the index
    (``pd.read_csv(path, index_col=0).iloc[:, 0].to_dict()``)."""
    frame = read_csv(path)
    index, values = list(frame.values())[:2]
    return dict(zip(index.tolist(), values.tolist()))


def preprocess(processed_data_path: str, raw_data_path: str, theme_num: int = -1,
               rebuild: bool = False) -> List[str]:
    uid2id = RawId2Id(osp.join(processed_data_path, "uid2id.json"), rebuild)
    pid2id = RawId2Id(osp.join(processed_data_path, "pid2id.json"), rebuild)
    theme2id = RawId2Id(osp.join(processed_data_path, "themeid2id.json"), rebuild)

    df = read_csv(osp.join(raw_data_path, "theme_click_log.csv"))
    df["theme_id"] = np.array([theme2id.fit_transform(v) for v in df["theme_id"].tolist()],
                              dtype=np.int64)
    user_dict = _embedding_dict(osp.join(raw_data_path, "user_embedding.csv"))
    item_dict = _embedding_dict(osp.join(raw_data_path, "item_embedding.csv"))

    # only the interactions with pretrained embeddings (preprocess:40-44)
    keep = [u in user_dict and i in item_dict
            for u, i in zip(df["user_id"].tolist(), df["item_id"].tolist())]
    df = take(df, np.flatnonzero(np.asarray(keep, dtype=bool)))

    os.makedirs(processed_data_path, exist_ok=True)
    out: List[str] = []
    for name, rows in group_rows(df["theme_id"]):
        if theme_num != -1 and len(out) >= theme_num:
            break
        processed = osp.join(processed_data_path, f"theme_{name}.csv")
        if not rebuild and osp.exists(processed):
            out.append(processed)
            continue
        group = {
            "user_id": np.array([uid2id.fit_transform(v) for v in df["user_id"][rows].tolist()],
                                dtype=np.int64),
            "item_id": np.array([pid2id.fit_transform(v) for v in df["item_id"][rows].tolist()],
                                dtype=np.int64),
        }
        write_csv(processed, group)
        out.append(processed)

    uid2id.export(osp.join(processed_data_path, "uid2id.json"))
    pid2id.export(osp.join(processed_data_path, "pid2id.json"))
    theme2id.export(osp.join(processed_data_path, "themeid2id.json"))

    # the pretrained vectors keyed by the remapped int id (preprocess:83-94)
    for fname, id_map, table in (("user_emb.json", uid2id, user_dict),
                                 ("item_emb.json", pid2id, item_dict)):
        emb = {}
        for raw, i in id_map.raw_id2id.items():
            key = _coerce_key(raw, table)
            if key is not None:
                emb[str(i)] = str(table[key])
        with open(osp.join(processed_data_path, fname), "w") as f:
            json.dump(emb, f)
    return out


def _coerce_key(raw: str, d: dict):
    """RawId2Id stringifies keys; embedding csv indices may be ints."""
    if raw in d:
        return raw
    try:
        k = int(raw)
        if k in d:
            return k
    except ValueError:
        pass
    return None


def split_to_domains(conf: dict) -> int:
    split_save_path = conf["split_save_path"]
    processed_data_path = osp.join(split_save_path, conf["processed_data_path"])
    files = preprocess(processed_data_path, conf["raw_data_path"],
                       theme_num=conf.get("theme_num", -1), rebuild=conf.get("rebuild", False))
    n = split_domains(files, split_save_path, conf,
                      rename_cols={"user_id": "uid", "item_id": "pid"})
    print(f"Split {n} domains at: {split_save_path}")
    return n


if __name__ == "__main__":
    parser = argparse.ArgumentParser(prog="python -m mamdr_tpu_torch.data.etl.taobao")
    parser.add_argument("--config", type=str, required=True)
    args = parser.parse_args()
    with open(args.config) as f:
        conf = json.load(f)
    random.seed(conf["seed"])
    split_to_domains(conf)
