"""Synthetic multi-domain CTR dataset for tests and the chip smoke run.

A copy of ``make_synthetic_dataset`` from ``mamdr_tpu/data/synthetic.py``:
a seeded factorization-structured dataset whose labels follow
sigmoid(u·v + domain-specific tilt), with long-tailed per-domain sizes. The
numpy draws are made in the same order, so the same seed gives arrays
identical to the JAX package's.
"""

from __future__ import annotations

from typing import List

import numpy as np

from mamdr_tpu_torch.data.dataset import DomainSplit, MultiDomainDataset


def make_synthetic_dataset(
    n_domain: int = 3,
    n_uid: int = 100,
    n_pid: int = 100,
    n_per_domain: int = 2048,
    seed: int = 123,
    latent_dim: int = 8,
    long_tail: bool = True,
    batch_size: int = 256,
) -> MultiDomainDataset:
    rng = np.random.default_rng(seed)
    u_latent = rng.normal(0, 1, (n_uid, latent_dim)).astype(np.float32)
    v_latent = rng.normal(0, 1, (n_pid, latent_dim)).astype(np.float32)
    # Per-domain linear tilt of the interaction space: domains share structure
    # but disagree — the regime MAMDR targets.
    tilts = rng.normal(0, 0.5, (n_domain, latent_dim)).astype(np.float32)

    train: List[DomainSplit] = []
    val: List[DomainSplit] = []
    test: List[DomainSplit] = []
    for d in range(n_domain):
        n = n_per_domain
        if long_tail and d > 0:
            n = max(64, int(n_per_domain / (1.5 ** d)))
        uid = rng.integers(0, n_uid, n).astype(np.int32)
        pid = rng.integers(0, n_pid, n).astype(np.int32)
        score = np.sum(u_latent[uid] * (v_latent[pid] + tilts[d]), axis=1)
        score = score / np.sqrt(latent_dim)
        prob = 1.0 / (1.0 + np.exp(-3.0 * score))
        label = (rng.uniform(0, 1, n) < prob).astype(np.float32)
        dom = np.full(n, d, np.int32)

        # Stratified-ish 60/20/20 split per domain (reference recipe ratio,
        # dataset/Amazon/split.py:73-90).
        perm = rng.permutation(n)
        n_tr, n_va = int(n * 0.6), int(n * 0.2)
        tr, va, te = perm[:n_tr], perm[n_tr : n_tr + n_va], perm[n_tr + n_va :]
        full = DomainSplit.from_arrays(uid, pid, dom, label)
        train.append(full.take(tr))
        val.append(full.take(va))
        test.append(full.take(te))

    return MultiDomainDataset(
        train, val, test, n_uid=n_uid, n_pid=n_pid, seed=seed, batch_size=batch_size
    )
