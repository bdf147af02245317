"""The bench workload at the shapes of the JAX package's bench.py, and the
same data under the corpus's other base models.

``mlp_meta_mamdr_finetune`` at Taobao-30 shapes (bench.py:47-121): 30
domains of 20000 rows (12000 train, 4000 val, 4000 test), 100k users and
items, frozen pretrained 128-d user/item tables drawn N(0, 0.1) from
``default_rng(0)``, a trainable 30x128 domain table, MLP 384-256-128-64-1
with dropout 0.5, batch 1024, flat Adam at lr 1e-3, meta lr 0.1, one epoch,
then the finetune stage (SGD at lr 1e-3). The same data and tables serve
the other MLP strategies of the corpus (``BENCH_MODELS``: joint, separate,
finetune, Domain Negotiation, Reptile, MAML, MLDG, PCGrad and uncertainty
weighting), each with the corpus's Taobao-30 train-block values for its
name (``benchmarks._train_block``: learning rates, meta split and ratio,
sample_num) at ``epoch`` 1. The zoo's names (WDL, DeepFM, NFM, AutoInt,
CCPM, PNN, SharedBottom, MMoE, PLE, and MAMDR on DeepFM and MMoE) take the
corpus's model block for their name at Taobao_30 (``benchmarks._model_block``:
the MTL widths and expert counts, AutoInt / CCPM / PNN defaults, dropout
0.5) on the same data, and so do STAR's (``star``, ``star_meta_mamdr_finetune``:
PartitionedNorm, StarFCN [256, 128, 64], auxiliary width 64 unused, no
dropout; MAMDR with ``meta_parms`` ["emb", "kernel_shared", "bias_shared"]
and ``sample_num`` 5). ``write_domain_tree`` writes
them in the reference's on-disk layout, which ``MultiDomainDataset.from_disk``
and the CLI (``python -m mamdr_tpu_torch.run``) read. Used by
chip_smoke.py and kernel_profile.py.
"""

from __future__ import annotations

import io
import json
import os
import os.path as osp
from typing import Optional

import numpy as np

from mamdr_tpu_torch.benchmarks import BENCHMARK_DATASETS, _model_block, _train_block
from mamdr_tpu_torch.config import ExperimentConfig
from mamdr_tpu_torch.data.dataset import MultiDomainDataset
from mamdr_tpu_torch.data.synthetic import make_synthetic_dataset
from mamdr_tpu_torch.strategies.mamdr import MAMDRStrategy
from mamdr_tpu_torch.train.trainer import Trainer

BENCH = dict(n_domain=30, n_uid=100_000, n_pid=100_000, n_per_domain=20_000,
             batch_size=1024, emb_dim=128)
# The MLP model names of the corpus (benchmarks.MODEL_VARIANTS) that the port runs.
MLP_MODELS = ("mlp", "mlp_separate", "mlp_finetune",
              "mlp_meta_domain_negotiation_finetune", "mlp_meta_reptile_finetune",
              "mlp_meta_mamdr_finetune", "mlp_meta_maml_finetune",
              "mlp_meta_mldg_finetune", "mlp_pcgrad", "mlp_uncertainty_weight")
# The corpus's other base models without batch statistics (joint), and MAMDR
# on one single-tower and one MTL base (not corpus names; the substring
# dispatch builds them, and the JAX package runs them).
ZOO_MODELS = ("wdl", "deepfm", "nfm", "autoint", "ccpm", "pnn", "shared_bottom", "mmoe",
              "ple")
ZOO_MAMDR_MODELS = ("deepfm_meta_mamdr_finetune", "mmoe_meta_mamdr_finetune")
# STAR, the model with per-domain batch statistics: its two corpus names.
STAR_MODELS = ("star", "star_meta_mamdr_finetune")
BENCH_MODELS = MLP_MODELS + ZOO_MODELS + ZOO_MAMDR_MODELS + STAR_MODELS
# The corpus's per-name train values a bench trainer takes (Taobao_30).
CORPUS_KEYS = ("learning_rate", "meta_learning_rate", "meta_split", "meta_split_ratio",
               "sample_num", "meta_parms")


def bench_config(dr_parallel: str = "auto", checkpoint_path: str = "checkpoint",
                 model: str = "mlp_meta_mamdr_finetune") -> ExperimentConfig:
    corpus = _train_block(BENCHMARK_DATASETS["Taobao_30"], model)
    cfg = {
        "model": _model_block(model, "Taobao_30"),
        "train": {"load_pretrain_emb": True, "emb_trainable": False,
                  "learning_rate": 1e-3, "meta_learning_rate": 0.1,
                  "merged_method": "plus", "sample_num": 5, "add_query_domain": True,
                  "shuffle_sequence": True, "epoch": 1,
                  "dr_parallel": dr_parallel, "checkpoint_path": checkpoint_path},
        "dataset": {"name": "synthetic", "batch_size": BENCH["batch_size"], "seed": 123},
    }
    cfg["train"].update({k: corpus[k] for k in CORPUS_KEYS if k in corpus})
    return ExperimentConfig.from_dict(cfg)


def bench_dataset() -> MultiDomainDataset:
    """The bench data: balanced synthetic domains and the frozen tables."""
    b = BENCH
    ds = make_synthetic_dataset(
        n_domain=b["n_domain"], n_uid=b["n_uid"], n_pid=b["n_pid"],
        n_per_domain=b["n_per_domain"], seed=123, long_tail=False,
        batch_size=b["batch_size"],
    )
    rng = np.random.default_rng(0)
    ds.user_emb = rng.normal(0, 0.1, (b["n_uid"], b["emb_dim"])).astype(np.float32)
    ds.item_emb = rng.normal(0, 0.1, (b["n_pid"], b["emb_dim"])).astype(np.float32)
    return ds


def build_bench_trainer(model: str = "mlp_meta_mamdr_finetune", device=None,
                        checkpoint_path: str = "checkpoint", verbose: bool = False,
                        dataset: Optional[MultiDomainDataset] = None,
                        dr_parallel: str = "auto") -> Trainer:
    """A trainer for `model` (one of BENCH_MODELS) at bench shapes with
    `epoch` 1, on `dataset` (default: ``bench_dataset()``)."""
    if model not in BENCH_MODELS:
        raise ValueError(f"model {model!r} is not one of {BENCH_MODELS}")
    return Trainer(bench_config(dr_parallel, checkpoint_path, model),
                   dataset if dataset is not None else bench_dataset(),
                   device=device, verbose=verbose)


def build_bench_strategy(device=None, dr_parallel: str = "auto",
                         checkpoint_path: str = "checkpoint", verbose: bool = False):
    """(trainer, strategy) for the MAMDR bench workload, fused phases
    prepared. ``dr_parallel`` "off" gives the sequential DR phase instead of
    the lanes; checkpoints and the metrics log go under ``checkpoint_path``."""
    trainer = build_bench_trainer(device=device, checkpoint_path=checkpoint_path,
                                  verbose=verbose, dr_parallel=dr_parallel)
    strat = MAMDRStrategy(trainer)
    strat.prepare_fused()
    return trainer, strat


def write_domain_tree(ds: MultiDomainDataset, root: str) -> None:
    """Write `ds` in the reference's on-disk layout under `root` (the
    ``<dataset_path>/<domain_split_path>`` of a config):
    ``domain_<i>/{train,val,test}.csv`` (header uid,pid,domain,label),
    ``processed_data/{uid2id,pid2id}.json`` with the ``"id"`` counts, the
    pretrained tables as ``processed_data/{user_emb,item_emb}.json`` ({id:
    "f f ..."}, each float with 9 significant digits, which round-trips
    float32) when `ds` has them, and ``domain_<i>/domain_property.json`` for
    the domains in ``ds.ctr_ratio``."""
    proc = osp.join(root, "processed_data")
    os.makedirs(proc, exist_ok=True)
    for fname, n in (("uid2id.json", ds.n_uid), ("pid2id.json", ds.n_pid)):
        with open(osp.join(proc, fname), "w") as f:
            json.dump({"id": int(n)}, f)
    for fname, table in (("user_emb.json", ds.user_emb), ("item_emb.json", ds.item_emb)):
        if table is None:
            continue
        text = io.StringIO()
        np.savetxt(text, table, fmt="%.9g", delimiter=" ")
        rows = text.getvalue().splitlines()
        with open(osp.join(proc, fname), "w") as f:
            json.dump({str(i): r for i, r in enumerate(rows)}, f)
    for i in range(ds.n_domain):
        d = osp.join(root, f"domain_{i}")
        os.makedirs(d, exist_ok=True)
        for mode in ("train", "val", "test"):
            s = getattr(ds, mode)[i]
            cols = np.column_stack([s.uid, s.pid, s.domain, s.label.astype(np.float64)])
            np.savetxt(osp.join(d, f"{mode}.csv"), cols, fmt="%d,%d,%d,%.9g",
                       header="uid,pid,domain,label", comments="")
        if i in ds.ctr_ratio:
            with open(osp.join(d, "domain_property.json"), "w") as f:
                json.dump({"ctr_ratio": ds.ctr_ratio[i]}, f)
