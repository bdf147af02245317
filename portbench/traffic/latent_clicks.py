"""The one generator of the benchmark's traffic: a multi-domain click log.

A frozen copy of the recipe of the port's learned-AUC validation
(``validate.build_raw``, itself the JAX package's validation scripts'),
made in bulk on the device from one seed:

- a rank-``latent_dim`` latent model: users and items ~ N(0, 1); with a
  configuration that loads pretrained tables, those tables are the latents
  projected into ``user_dim`` (N(0, 1/latent_dim) projection) plus
  N(0, ``latent_noise``) noise, the frozen "pretrained" vectors;
- domain d covers a slice of the items (``n_pid // n_domain`` of them),
  exposed with the zipf weights 1 / (rank + ``zipf_offset``), users
  uniform, and its own tilt ~ N(0, ``tilt_std``) of the item latents;
- a row's affinity is u . (v + tilt_d) / sqrt(latent_dim); it clicks where
  ``click_slope`` * affinity plus logistic noise is among the domain's top
  ``ctr_d`` share, ``ctr_d`` ~ U(``ctr_range``) a domain (the reference's
  ``ctr_ratio_range``);
- domain d holds n_d rows, n_d proportional to ``size_decay`` ** -d with
  ``rows_per_domain`` * n_domain rows in all (1: balanced), split
  ``split`` (60/20/20) into train, val and test by a random permutation.

Every seed gives the same sizes; only the rows differ.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

Split = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # uid int32, pid int32, label float32


@dataclass
class Traffic:
    sizes: List[int]                       # rows a domain, all splits
    splits: Dict[str, List[Split]]         # "train" / "val" / "test": a domain's columns
    ctr: List[float]
    tables: Optional[Dict[str, torch.Tensor]]  # "user_emb", "item_emb" when pretrained


def domain_sizes(n_domain: int, rows_per_domain: int, decay: float) -> List[int]:
    """n_d proportional to decay ** -d, rows_per_domain * n_domain in all."""
    w = [decay ** -d for d in range(n_domain)]
    total = rows_per_domain * n_domain
    return [int(round(total * x / sum(w))) for x in w]


def generate(cfg: Dict, mix: Dict, seed: int, device) -> Traffic:
    g = torch.Generator(device=device).manual_seed(int(seed))
    n_dom, n_uid, n_pid = cfg["n_domain"], cfg["n_uid"], cfg["n_pid"]
    k = int(mix["latent_dim"])
    sizes = domain_sizes(n_dom, int(mix["rows_per_domain"]), float(mix["size_decay"]))

    def normal(*shape):
        return torch.randn(shape, generator=g, device=device)

    def uniform(*shape):
        return torch.rand(shape, generator=g, device=device)

    u_lat, v_lat = normal(n_uid, k), normal(n_pid, k)
    tables = None
    if cfg["load_pretrain_emb"]:
        dim = cfg["user_dim"]
        proj = normal(k, dim) / math.sqrt(k)
        noise = float(mix["latent_noise"])
        tables = {"user_emb": u_lat @ proj + noise * normal(n_uid, dim),
                  "item_emb": v_lat @ proj + noise * normal(n_pid, dim)}
    tilt = normal(n_dom, k) * float(mix["tilt_std"])
    lo, hi = mix["ctr_range"]
    ctr = (lo + (hi - lo) * uniform(n_dom)).tolist()

    total = sum(sizes)
    dom = torch.repeat_interleave(torch.arange(n_dom, device=device),
                                  torch.tensor(sizes, device=device))
    uid = torch.randint(0, n_uid, (total,), generator=g, device=device)
    per = n_pid // n_dom
    zipf = 1.0 / (torch.arange(per, device=device, dtype=torch.float32)
                  + float(mix["zipf_offset"]))
    rank = torch.multinomial(zipf, total, replacement=True, generator=g)
    pid = dom * per + rank
    aff = torch.sum(u_lat[uid] * (v_lat[pid] + tilt[dom]), dim=1) / math.sqrt(k)
    u = uniform(total).clamp(1e-7, 1.0 - 1e-7)
    score = float(mix["click_slope"]) * aff + torch.log(u / (1.0 - u))
    order = uniform(total)

    splits: Dict[str, List[Split]] = {"train": [], "val": [], "test": []}
    fr_train, fr_val, _ = mix["split"]
    start = 0
    for d, n in enumerate(sizes):
        seg = slice(start, start + n)
        start += n
        clicks = int(round(ctr[d] * n))
        label = torch.zeros(n, device=device)
        label[torch.topk(score[seg], clicks).indices] = 1.0
        perm = torch.argsort(order[seg])
        n_tr, n_va = int(n * fr_train), int(n * fr_val)
        cols = (uid[seg].to(torch.int32), pid[seg].to(torch.int32), label)
        for name, part in (("train", perm[:n_tr]), ("val", perm[n_tr:n_tr + n_va]),
                           ("test", perm[n_tr + n_va:])):
            splits[name].append(tuple(c[part] for c in cols))
    return Traffic(sizes=sizes, splits=splits, ctr=ctr, tables=tables)
