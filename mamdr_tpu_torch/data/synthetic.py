"""Synthetic multi-domain CTR data for tests and the chip smoke run.

Copies of ``make_synthetic_dataset`` and ``generate_amazon_reviews`` from
``mamdr_tpu/data/synthetic.py``: a seeded factorization-structured dataset
whose labels follow sigmoid(u·v + domain-specific tilt), with long-tailed
per-domain sizes, and synthetic per-category Amazon review files for the
Amazon ETL. The numpy draws are made in the same order, so the same seed
gives arrays (and review lines) identical to the JAX package's.
"""

from __future__ import annotations

from typing import List, Optional

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


def generate_amazon_reviews(
    out_dir: str,
    *,
    sizes: List[int],
    items: List[int],
    n_users: int,
    lat: int = 16,
    beta: float = 0.5,
    pop_offset: float = 40.0,
    noise: float = 0.05,
    slope: float = 3.0,
    thresh: float = 0.5,
    seed: int = 17,
    cat_names: Optional[List[str]] = None,
    dom_fn: str = "tanh",
) -> str:
    """Per-category Amazon-style review files (``Cat_i.json.gz``) for the
    Amazon ETL, in place of the reference's download. A latent click model:
    each user has a shared core ``u_core`` plus a per-category component,
    mixed in with weight ``sqrt(1 - beta)`` (``beta`` 1: every category
    shares one preference; below 1, the categories disagree). ``dom_fn``
    shapes the per-category component: ``tanh`` of a rotation of the core,
    ``abs`` or ``hermite2`` of it standardised (no linear correlation with
    the core), or ``noise``, a fresh draw per user and category.
    ``pop_offset`` sets the item popularity's skew (larger: flatter),
    ``noise`` mixes labels toward coin flips, ``sizes`` / ``items`` set each
    category's rows and items."""
    import gzip
    import json
    import os
    import os.path as osp

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    u_core = rng.normal(0, 1, (n_users, lat)).astype(np.float32)
    if cat_names is None:
        cat_names = [f"Cat_{ci}" for ci in range(len(sizes))]
    for ci, (n_rows, n_items) in enumerate(zip(sizes, items)):
        q, _ = np.linalg.qr(rng.normal(0, 1, (lat, lat)))
        rot = u_core @ q.astype(np.float32)
        if dom_fn == "tanh":
            u_dom = np.tanh(rot) * 1.594
        elif dom_fn == "abs":
            u_dom = np.abs(rot)
            u_dom = (u_dom - u_dom.mean(0)) / u_dom.std(0)
        elif dom_fn == "hermite2":
            u_dom = (rot * rot - 1.0) / np.sqrt(2.0)
            u_dom = (u_dom - u_dom.mean(0)) / u_dom.std(0)
        elif dom_fn == "noise":
            u_dom = rng.normal(0, 1, (n_users, lat)).astype(np.float32)
        else:
            raise ValueError(f"unknown dom_fn: {dom_fn!r}")
        u_eff = np.sqrt(beta) * u_core + np.sqrt(1.0 - beta) * u_dom
        v_lat = rng.normal(0, 1, (n_items, lat)).astype(np.float32)
        p = 1.0 / (np.arange(n_items) + pop_offset)
        p /= p.sum()
        chosen = np.empty(0, np.int64)
        while chosen.shape[0] < n_rows:
            m = 4 * (n_rows - chosen.shape[0]) + 1000
            us = rng.integers(0, n_users, m)
            vs = rng.choice(n_items, size=m, p=p)
            aff = np.sum(u_eff[us] * v_lat[vs], axis=1) / np.sqrt(lat)
            prob = 1.0 / (1.0 + np.exp(-slope * (aff - thresh)))
            prob = (1.0 - noise) * prob + noise * 0.5
            keep = rng.uniform(0, 1, m) < prob
            new = us[keep].astype(np.int64) * 1_000_000 + vs[keep]
            chosen = np.unique(np.concatenate([chosen, new]))
        chosen = chosen[rng.permutation(chosen.shape[0])[:n_rows]]
        path = osp.join(out_dir, cat_names[ci].replace(" ", "_") + ".json.gz")
        with gzip.open(path, "wt") as f:
            for k in chosen:
                u, v = int(k // 1_000_000), int(k % 1_000_000)
                f.write(json.dumps({
                    "reviewerID": f"u{u}",
                    "asin": f"c{ci}-i{v}",
                    "overall": 5.0,
                }) + "\n")
    return out_dir
