"""Learned-AUC validation of the port on the card: a generated Taobao
theme-click log whose clicks live in the space of its "pretrained" user and
item vectors, the port's Taobao ETL, and models trained on it.

    python3 -m mamdr_tpu_torch.validate --scale taobao10
    python3 -m mamdr_tpu_torch.validate --scale taobao30 --models mlp mlp_meta_mamdr_finetune
    python3 -m mamdr_tpu_torch.validate --scale taobao10 --root /tmp/v

The recipe is the one of the JAX package's validation scripts
(``scripts/validate_taobao10.py`` and ``validate_taobao30.py``): ``build_raw``
draws, from ``default_rng(11)``, a rank-8 latent model inside 128-d vectors
for 3000 users and 4000 items over 10 themes (5000 x 9000 over 30), each
theme an item slice with its own tilt and zipf exposure, clicks where the
affinity is high, and writes the same three raw files byte for byte;
``build_split`` builds the domains with ``data.etl.taobao`` (ctr_ratio drawn
from [0.2, 0.5], 60/20/20, seed 123). Each model then trains on
``MultiDomainDataset.from_disk`` (batch 1024, seed 123) with
``benchmark_config("Taobao-10" | "Taobao_30", name)``, ``epoch`` 40 and
``patience`` 10, on the card. Printed: the build's seconds and rows, one JSON line per
model (test macro and weighted AUC, epochs validated, seconds, the val macro
AUC of each epoch), then the card's name and power limit.

Everything is written under ``--root`` (default
``validation_data_torch/<scale>``); the root must not be another
``validation_data*`` directory, and nothing else is written.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import time
from typing import Optional, Sequence

import numpy as np

EMB_DIM = 128
SCALES = {
    "taobao10": {"n_users": 3000, "n_items": 4000, "n_theme": 10,
                 "sizes": [30000, 22000, 17000, 13000, 10000, 8000, 6500, 5200, 4200, 3400],
                 "bench": "Taobao-10"},
    "taobao30": {"n_users": 5000, "n_items": 9000, "n_theme": 30,
                 "sizes": [int(30000 / (1.12 ** i)) for i in range(30)],
                 "bench": "Taobao_30"},
}
MODELS = ("mlp", "mlp_meta_mamdr_finetune")
EPOCH_CAP, PATIENCE = 40, 10  # the JAX package's validation scripts'


def _write_rows(path: str, header: Sequence[str], rows) -> None:
    import csv

    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        w.writerows(rows)


def build_raw(root: str, scale: str) -> str:
    """``<root>/raw`` with ``theme_click_log.csv`` (user_id, item_id,
    theme_id) and the ``user_embedding.csv`` / ``item_embedding.csv``
    vectors (4 decimals, space-separated), made unless the log exists."""
    sc = SCALES[scale]
    raw = osp.join(root, "raw")
    os.makedirs(raw, exist_ok=True)
    if osp.exists(osp.join(raw, "theme_click_log.csv")):
        return raw
    rng = np.random.default_rng(11)
    n_users, n_items, n_theme = sc["n_users"], sc["n_items"], sc["n_theme"]
    # the latent structure is the pretrained embedding (rank 8 inside 128 dims)
    u_lat = rng.normal(0, 1, (n_users, 8))
    v_lat = rng.normal(0, 1, (n_items, 8))
    proj = rng.normal(0, 1, (8, EMB_DIM)) / np.sqrt(8)
    u_emb = (u_lat @ proj + rng.normal(0, 0.05, (n_users, EMB_DIM))).astype(np.float32)
    v_emb = (v_lat @ proj + rng.normal(0, 0.05, (n_items, EMB_DIM))).astype(np.float32)

    # each theme covers an item slice with its own tilt; a click where the
    # affinity is high; zipf item exposure
    items_per_theme = n_items // n_theme
    rows = []
    for th in range(n_theme):
        lo = th * items_per_theme
        theme_items = np.arange(lo, lo + items_per_theme)
        p = 1.0 / (np.arange(items_per_theme) + 15.0)
        p /= p.sum()
        tilt = rng.normal(0, 0.3, 8)
        need = sc["sizes"][th]
        seen = set()
        while need > 0:
            us = rng.integers(0, n_users, 4 * need)
            vs = theme_items[rng.choice(items_per_theme, size=4 * need, p=p)]
            aff = np.sum(u_lat[us] * (v_lat[vs] + tilt), axis=1) / np.sqrt(8)
            keep = rng.uniform(0, 1, 4 * need) < 1.0 / (1.0 + np.exp(-3.0 * (aff - 0.5)))
            for u, v in zip(us[keep], vs[keep]):
                k = (int(u), int(v))
                if k not in seen:
                    seen.add(k)
                    rows.append((f"u{u}", f"i{v}", 1000 + th))
                    need -= 1
                if need <= 0:
                    break
    _write_rows(osp.join(raw, "theme_click_log.csv"), ["user_id", "item_id", "theme_id"], rows)
    for fname, key, prefix, emb in (("user_embedding.csv", "user_id", "u", u_emb),
                                    ("item_embedding.csv", "item_id", "i", v_emb)):
        _write_rows(osp.join(raw, fname), [key, "emb"],
                    ((f"{prefix}{i}", " ".join(f"{x:.4f}" for x in emb[i]))
                     for i in range(emb.shape[0])))
    return raw


def split_path(root: str, scale: str) -> str:
    return osp.join(root, f"split_by_theme_{SCALES[scale]['n_theme']}")


def build_split(raw: str, root: str, scale: str) -> str:
    """The domains of ``raw`` under ``split_path(root, scale)`` through the
    port's Taobao ETL, unless its last domain exists."""
    from mamdr_tpu_torch.data.etl import taobao

    n_theme = SCALES[scale]["n_theme"]
    out = split_path(root, scale)
    if not osp.exists(osp.join(out, f"domain_{n_theme - 1}", "train.csv")):
        taobao.split_to_domains({
            "raw_data_path": raw, "split_save_path": out,
            "processed_data_path": "processed_data", "theme_num": n_theme,
            "ctr_ratio": 0.3, "random_range": True, "ctr_ratio_range": [0.2, 0.5],
            "train_val_test": [0.6, 0.2, 0.2], "seed": 123, "rebuild": False,
        })
    return out


def load(root: str, scale: str):
    """The built domains as a ``MultiDomainDataset`` (batch 1024, seed 123)."""
    from mamdr_tpu_torch.config import DatasetConfig
    from mamdr_tpu_torch.data.dataset import MultiDomainDataset

    return MultiDomainDataset.from_disk(DatasetConfig(
        name="Taobao", dataset_path=root, domain_split_path=osp.basename(split_path(root, scale)),
        batch_size=1024, seed=123))


def train_one(dataset, scale: str, name: str, root: str, epoch: int = EPOCH_CAP,
              patience: int = PATIENCE) -> dict:
    """``name`` under the corpus's config for the scale, ``epoch`` /
    ``patience`` set, through ``run()``: test macro and weighted AUC, the
    epochs validated, seconds."""
    from mamdr_tpu_torch.benchmarks import benchmark_config
    from mamdr_tpu_torch.strategies.base import build_strategy
    from mamdr_tpu_torch.train.trainer import Trainer

    cfg = benchmark_config(SCALES[scale]["bench"], name)
    cfg.train.epoch = epoch
    cfg.train.patience = patience
    cfg.train.checkpoint_path = osp.join(root, "ckpt")
    cfg.train.result_save_path = osp.join(root, "result")
    t0 = time.perf_counter()
    trainer = Trainer(cfg, dataset, verbose=False)
    _, avg_auc, _, domain_auc = build_strategy(trainer).run()
    seconds = time.perf_counter() - t0
    val_auc = []
    log = osp.join(trainer.checkpoint_dir, "metrics.jsonl")
    if osp.exists(log):
        with open(log) as f:
            val_auc = [r["avg_auc"] for r in map(json.loads, f) if r["event"] == "val_eval"]
    return {"model": name, "scale": scale, "test_macro_auc": avg_auc,
            "test_weighted_auc": trainer.weighted_auc("test", domain_auc),
            "epochs": trainer._eval_epoch_counter, "epoch_cap": epoch, "patience": patience,
            "seconds": seconds, "val_macro_auc_by_epoch": val_auc}


def _check_root(root: str) -> None:
    for part in osp.normpath(osp.abspath(root)).split(os.sep):
        if part.startswith("validation_data") and part != "validation_data_torch":
            raise ValueError(f"--root {root}: the JAX package's validation data is not "
                             "written to; choose another directory")


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m mamdr_tpu_torch.validate")
    parser.add_argument("--scale", choices=sorted(SCALES), required=True)
    parser.add_argument("--models", nargs="+", default=list(MODELS))
    parser.add_argument("--root", default=None,
                        help="working directory (default validation_data_torch/<scale>)")
    args = parser.parse_args(argv)
    root = args.root or osp.join("validation_data_torch", args.scale)
    _check_root(root)

    t0 = time.perf_counter()
    raw = build_raw(root, args.scale)
    raw_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    build_split(raw, root, args.scale)
    etl_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dataset = load(root, args.scale)
    load_s = time.perf_counter() - t0
    rows = {m: sum(s.n for s in getattr(dataset, m)) for m in ("train", "val", "test")}
    print(json.dumps({"scale": args.scale, "raw_seconds": raw_s, "etl_seconds": etl_s,
                      "load_seconds": load_s, "domains": dataset.n_domain, "rows": rows}),
          flush=True)
    for name in args.models:
        print(json.dumps(train_one(dataset, args.scale, name, root)), flush=True)
    from mamdr_tpu_torch.utils.timing import card_line

    print(card_line())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
