"""Multi-domain dataset: per-domain splits as packed numpy columns.

A copy of ``DomainSplit`` and ``MultiDomainDataset`` from
``mamdr_tpu/data/dataset.py``. Each domain split is four numpy columns (uid,
pid, domain, label — the on-disk CSV schema, reference
dataset/Amazon/split.py:20); the training engine (``train/fused.py``) moves
them to the device once. Every batch comes from exactly one domain
(the reference's single-domain-batch invariant, SURVEY §2.4).

File-backed datasets (``from_csv`` / ``from_disk``) are not ported yet.
"""

from __future__ import annotations

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

    @classmethod
    def from_arrays(cls, uid, pid, domain, label) -> "DomainSplit":
        return cls(
            np.asarray(uid, np.int32),
            np.asarray(pid, np.int32),
            np.asarray(domain, np.int32),
            np.asarray(label, np.float32),
        )


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
