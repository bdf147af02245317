"""The weights the benchmark hands to both sides, made on the device from a
seed in a few large draws.

Leaves by the reference's names (``reference.mamdr_mlp.leaf_order``): a
trainable table N(0, 1e-4) (deepctr's embedding default), a kernel [in,
out] glorot-uniform, a bias 0, the logit kernel N(0, 2 / (fan_in +
fan_out)). ``shared`` holds every trainable leaf; each domain's specific
start is a fresh draw of the same initialisers (``specific_init``
"random", the reference's ``init_layer``) or zeros. Frozen tables are the
traffic's pretrained ones.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from portbench.reference.mamdr_mlp import TABLES, leaf_order

Tree = Dict[str, torch.Tensor]


def shapes(cfg: Dict) -> Dict[str, Tuple[int, ...]]:
    dims = [3 * cfg["user_dim"], *cfg["hidden_dim"]]
    out = {"user_emb": (cfg["n_uid"], cfg["user_dim"]), "item_emb": (cfg["n_pid"], cfg["user_dim"]),
           "domain_emb": (cfg["n_domain"], cfg["user_dim"])}
    for i in range(len(cfg["hidden_dim"])):
        out[f"W{i}"] = (dims[i], dims[i + 1])
        out[f"b{i}"] = (dims[i + 1],)
    out["Wl"] = (dims[-1], 1)
    return out


def trainable(cfg: Dict) -> List[str]:
    frozen = () if cfg["emb_trainable"] else ("user_emb", "item_emb")
    return [n for n in leaf_order(len(cfg["hidden_dim"])) if n not in frozen]


def _draw(names: List[str], shp: Dict, copies: int, g: torch.Generator, device) -> List[Tree]:
    """``copies`` trees of the leaves ``names``: one uniform and one normal
    draw for all of them, scaled leaf by leaf."""
    sizes = [math.prod(shp[n]) for n in names]
    n = sum(sizes)
    uni = torch.rand((copies, n), generator=g, device=device) * 2.0 - 1.0
    nor = torch.randn((copies, n), generator=g, device=device)
    trees = []
    for c in range(copies):
        tree, off = {}, 0
        for name, size in zip(names, sizes):
            s = shp[name]
            if name in TABLES:
                x = nor[c, off:off + size] * 1e-4
            elif name.startswith("b"):
                x = torch.zeros(size, device=device)
            elif name == "Wl":
                x = nor[c, off:off + size] * math.sqrt(2.0 / (s[0] + s[1]))
            else:
                x = uni[c, off:off + size] * math.sqrt(6.0 / (s[0] + s[1]))
            tree[name] = x.reshape(s).clone()
            off += size
        trees.append(tree)
    return trees


def make_weights(cfg: Dict, seed: int, device) -> Tuple[Tree, List[Tree]]:
    """(shared start, each domain's specific start) of the trainable leaves."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    shp, names = shapes(cfg), trainable(cfg)
    shared = _draw(names, shp, 1, g, device)[0]
    if cfg["specific_init"] == "zeros":
        specific = [{n: torch.zeros_like(x) for n, x in shared.items()}
                    for _ in range(cfg["n_domain"])]
    elif cfg["specific_init"] == "random":
        specific = _draw(names, shp, cfg["n_domain"], g, device)
    else:
        raise ValueError(f"unknown specific_init {cfg['specific_init']!r}")
    return shared, specific
