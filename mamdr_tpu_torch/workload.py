"""The flagship workload at the shapes of the JAX package's bench.py.

``mlp_meta_mamdr_finetune`` at Taobao-30 shapes (bench.py:47-121): 30
domains of 20000 rows (12000 train), 100k users and items, frozen pretrained
128-d user/item tables drawn N(0, 0.1) from ``default_rng(0)``, a trainable
30x128 domain table, MLP 384-256-128-64-1 with dropout 0.5, batch 1024, flat
Adam at lr 1e-3, meta lr 0.1. Used by chip_smoke.py and kernel_profile.py.
"""

from __future__ import annotations

import numpy as np

from mamdr_tpu_torch.config import ExperimentConfig
from mamdr_tpu_torch.data.synthetic import make_synthetic_dataset
from mamdr_tpu_torch.strategies.mamdr import MAMDRStrategy
from mamdr_tpu_torch.train.trainer import Trainer

BENCH = dict(n_domain=30, n_uid=100_000, n_pid=100_000, n_per_domain=20_000,
             batch_size=1024, emb_dim=128)


def bench_config() -> ExperimentConfig:
    return ExperimentConfig.from_dict({
        "model": {"name": "mlp_meta_mamdr_finetune", "user_dim": 128, "item_dim": 128,
                  "domain_dim": 128, "hidden_dim": [256, 128, 64], "dropout": 0.5},
        "train": {"load_pretrain_emb": True, "emb_trainable": False,
                  "learning_rate": 1e-3, "meta_learning_rate": 0.1,
                  "merged_method": "plus", "sample_num": 5, "add_query_domain": True,
                  "shuffle_sequence": True, "epoch": 1},
        "dataset": {"name": "synthetic", "batch_size": BENCH["batch_size"], "seed": 123},
    })


def build_bench_strategy(device=None):
    """(trainer, strategy) for the bench workload, fused phases prepared."""
    b = BENCH
    ds = make_synthetic_dataset(
        n_domain=b["n_domain"], n_uid=b["n_uid"], n_pid=b["n_pid"],
        n_per_domain=b["n_per_domain"], seed=123, long_tail=False,
        batch_size=b["batch_size"],
    )
    rng = np.random.default_rng(0)
    ds.user_emb = rng.normal(0, 0.1, (b["n_uid"], b["emb_dim"])).astype(np.float32)
    ds.item_emb = rng.normal(0, 0.1, (b["n_pid"], b["emb_dim"])).astype(np.float32)
    trainer = Trainer(bench_config(), ds, device=device)
    strat = MAMDRStrategy(trainer)
    strat.prepare_fused()
    return trainer, strat
