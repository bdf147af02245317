"""Multi-domain dataset: per-domain splits as packed numpy columns.

A copy of ``DomainSplit``, ``stack_batches``, ``split_support_query`` and
``MultiDomainDataset`` from ``mamdr_tpu/data/dataset.py``. Each domain split
is four numpy columns (uid, pid, domain, label — the on-disk CSV schema,
reference dataset/Amazon/split.py:20); the training engine
(``train/fused.py``) moves them to the device once. Every batch comes from exactly one domain
(the reference's single-domain-batch invariant, SURVEY §2.4).

``MultiDomainDataset.from_disk`` reads the reference's on-disk layout
(``domain_*/{train,val,test}.csv``, ``processed_data/*.json``) through the
native CSV loader (``data/native_loader.py``), giving the JAX package's
arrays bit for bit.
"""

from __future__ import annotations

import glob
import json
import os.path as osp
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

COLUMNS = ("uid", "pid", "domain", "label")


@dataclass
class DomainSplit:
    """One split (train/val/test) of one domain."""

    uid: np.ndarray     # int32 [N]
    pid: np.ndarray     # int32 [N]
    domain: np.ndarray  # int32 [N]
    label: np.ndarray   # float32 [N]

    @property
    def n(self) -> int:
        return int(self.uid.shape[0])

    def take(self, idx: np.ndarray) -> "DomainSplit":
        return DomainSplit(self.uid[idx], self.pid[idx], self.domain[idx], self.label[idx])

    def concat(self, other: "DomainSplit") -> "DomainSplit":
        return DomainSplit(
            np.concatenate([self.uid, other.uid]),
            np.concatenate([self.pid, other.pid]),
            np.concatenate([self.domain, other.domain]),
            np.concatenate([self.label, other.label]),
        )

    @classmethod
    def from_csv(cls, path: str) -> "DomainSplit":
        """CSV columns uid,pid,domain,label (reference split.py:20), parsed by
        the native loader; a file it refuses (a malformed row) by numpy."""
        from mamdr_tpu_torch.data.native_loader import load_csv_native, load_csv_reference

        cols = load_csv_native(path)
        if cols is None:
            cols = load_csv_reference(path)
        return cls(*cols)

    @classmethod
    def from_arrays(cls, uid, pid, domain, label) -> "DomainSplit":
        return cls(
            np.asarray(uid, np.int32),
            np.asarray(pid, np.int32),
            np.asarray(domain, np.int32),
            np.asarray(label, np.float32),
        )


def batch_rows(n: int, batch_size: int, shuffle: bool,
               rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """The row indices of one epoch of an n-row split, [n_steps * batch_size]:
    ``rng.permutation(n)`` (natural order when not shuffling), the last
    partial batch padded by wrapping around to the start of that order
    (modular: a split smaller than the pad tiles repeatedly). Positions from
    n on are the pad rows, which carry weight 0. One permutation draw, as the
    JAX package's ``stack_batches`` makes it."""
    if n == 0:
        raise ValueError("empty split")
    order = np.arange(n)
    if shuffle:
        assert rng is not None
        order = rng.permutation(n)
    n_steps = -(-n // batch_size)
    return np.concatenate([order, order[np.arange(n_steps * batch_size - n) % n]])


def stack_batches(split: DomainSplit, batch_size: int, shuffle: bool,
                  rng: Optional[np.random.Generator] = None) -> Dict[str, np.ndarray]:
    """One epoch packed into [n_steps, batch_size] numpy columns (JAX
    ``stack_batches``, dataset.py:90-120, bit for bit, pad rows included):
    the rows of ``batch_rows``, weight 1 on the real rows, 0 on the pad."""
    idx = batch_rows(split.n, batch_size, shuffle, rng)
    weight = np.ones(idx.shape[0], np.float32)
    weight[split.n:] = 0.0
    out = {k: getattr(split, k)[idx] for k in COLUMNS}
    out["weight"] = weight
    return {k: v.reshape(-1, batch_size) for k, v in out.items()}


def split_support_query(split: DomainSplit, mode: str, ratio: float,
                        rng: np.random.Generator):
    """Support/query division for the meta strategies (reference
    maml.py:294-341; JAX ``split_support_query``): the same draws from the
    same numpy generator, so the index sets and the generator's state
    afterwards are bit-equal.

    - ``train-train``: support = query = the full train set (no draw);
    - ``meta-train/val``: exclusive split, support = the first ``ratio``
      fraction of one permutation, query the rest (one row when nothing is
      left);
    - ``meta-train/val-no-exclusive``: support = the full set, query = a
      random ratio-sized subset.
    """
    if mode == "train-train":
        return split, split
    perm = rng.permutation(split.n)
    n_support = max(1, int(split.n * ratio))
    if mode == "meta-train/val":
        rest = perm[n_support:] if split.n - n_support > 0 else perm[:1]
        return split.take(perm[:n_support]), split.take(rest)
    if mode == "meta-train/val-no-exclusive":
        return split, split.take(perm[:n_support])
    raise ValueError(f"unknown meta_split mode {mode!r}")


class MultiDomainDataset:
    """All domains, all splits, plus vocab sizes and dataset_info
    (reference utils/dataset.py:41-130)."""

    def __init__(
        self,
        train: List[DomainSplit],
        val: List[DomainSplit],
        test: List[DomainSplit],
        n_uid: int,
        n_pid: int,
        user_emb: Optional[np.ndarray] = None,
        item_emb: Optional[np.ndarray] = None,
        seed: int = 123,
        batch_size: int = 1024,
        ctr_ratio: Optional[Dict[int, float]] = None,
        fixed_train: bool = False,
    ):
        if not len(train) == len(val) == len(test):
            raise ValueError("train/val/test must cover the same domains")
        self.train = train
        self.val = val
        self.test = test
        self.n_uid = n_uid
        self.n_pid = n_pid
        self.n_domain = len(train)
        self.user_emb = user_emb
        self.item_emb = item_emb
        self.seed = seed
        self.batch_size = batch_size
        self.ctr_ratio = ctr_ratio or {}
        # a stable train order: the trainer's fused passes shuffle, so it
        # routes every strategy to its per-call loop (Trainer.fused_padding_ok)
        self.fixed_train = fixed_train

    @property
    def dataset_info(self) -> Dict:
        """Per-domain example counts + ctr ratios + totals
        (reference utils/dataset.py:110-130)."""
        info: Dict = {"n_user": self.n_uid, "n_item": self.n_pid}
        tot_train = tot_val = tot_test = 0
        for i in range(self.n_domain):
            info[str(i)] = {
                "n_train": self.train[i].n,
                "n_val": self.val[i].n,
                "n_test": self.test[i].n,
            }
            if i in self.ctr_ratio:
                info[str(i)]["ctr_ratio"] = self.ctr_ratio[i]
            tot_train += self.train[i].n
            tot_val += self.val[i].n
            tot_test += self.test[i].n
        info["total_train"] = tot_train
        info["total_val"] = tot_val
        info["total_test"] = tot_test
        return info

    @classmethod
    def from_disk(cls, conf) -> "MultiDomainDataset":
        """Load the reference on-disk layout (reference utils/dataset.py:50-71):
        ``<dataset_path>/<domain_split_path>/domain_<i>/{train,val,test}.csv``
        (directories in the order of their integer suffix), vocab sizes from
        the ``"id"`` entry of ``processed_data/{uid2id,pid2id}.json``, for
        Taobao the pretrained ``processed_data/{user_emb,item_emb}.json``
        tables, and each domain's ``domain_property.json`` ``ctr_ratio``."""
        root = osp.join(conf.dataset_path, conf.domain_split_path)
        with open(osp.join(root, "processed_data/uid2id.json")) as f:
            n_uid = json.load(f)["id"]
        with open(osp.join(root, "processed_data/pid2id.json")) as f:
            n_pid = json.load(f)["id"]

        user_emb = item_emb = None
        if conf.name == "Taobao":
            user_emb = _load_pretrained_emb(osp.join(root, "processed_data/user_emb.json"), n_uid)
            item_emb = _load_pretrained_emb(osp.join(root, "processed_data/item_emb.json"), n_pid)

        domain_dirs = sorted(glob.glob(osp.join(root, "domain_*")),
                             key=lambda p: int(p.split("_")[-1]))
        if not domain_dirs:
            raise FileNotFoundError(f"no domain_* dirs under {root}")
        train, val, test = [], [], []
        ctr_ratio = {}
        for i, d in enumerate(domain_dirs):
            train.append(DomainSplit.from_csv(osp.join(d, "train.csv")))
            val.append(DomainSplit.from_csv(osp.join(d, "val.csv")))
            test.append(DomainSplit.from_csv(osp.join(d, "test.csv")))
            prop_path = osp.join(d, "domain_property.json")
            if osp.exists(prop_path):
                with open(prop_path) as f:
                    ctr_ratio[i] = json.load(f).get("ctr_ratio")
        return cls(train, val, test, n_uid, n_pid, user_emb=user_emb, item_emb=item_emb,
                   seed=conf.seed, batch_size=conf.batch_size, ctr_ratio=ctr_ratio,
                   fixed_train=getattr(conf, "fixed_train", False))


def _load_pretrained_emb(path: str, n_rows: int) -> np.ndarray:
    """The Taobao emb JSON {str(id): "f f f ..."} as a [n_rows, dim] float32
    table, rows not listed zero (reference utils/dataset.py:57-61). Each
    string is parsed straight to float32, as the JAX package does: a float64
    parse cast down can differ in the last bit."""
    with open(path) as f:
        raw = json.load(f)
    dim = len(next(iter(raw.values())).split())
    table = np.zeros((n_rows, dim), np.float32)
    for k, v in raw.items():
        table[int(k)] = np.fromstring(v, sep=" ", dtype=np.float32)
    return table
