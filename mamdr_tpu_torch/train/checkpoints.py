"""Checkpoints: atomic npz snapshots of parameter trees.

Counterpart of ``save_pytree``, ``load_pytree`` and ``save_decomposition``
of ``mamdr_tpu/train/checkpoints.py`` (:26-73, :152-178), in the same file
format: one npz array per leaf, keyed by its flax path with ``//`` between
the names (``model//dnn//Dense_0//Dense_0//kernel``), written to a temporary
file and renamed into place. A file either package writes, the other reads.
The train-state snapshots of a resumable run are not ported yet (ROADMAP.md
§1: resume state).
"""

from __future__ import annotations

import json
import os
import os.path as osp
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from mamdr_tpu_torch.utils import trees

SEP = "//"


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {name.replace("/", SEP): (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                                     else np.asarray(x))
            for name, x in trees.leaves_with_names(tree)}


def save_pytree(path: str, tree, keep=None) -> None:
    """Atomic npz write of ``tree``'s leaves; ``keep`` (a tree of bools of
    the same structure) leaves out the leaves it marks False."""
    os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
    flat = _flatten(tree)
    if keep is not None:
        keep_flat = _flatten(keep)
        flat = {k: v for k, v in flat.items() if bool(keep_flat[k])}
    fd, tmp = tempfile.mkstemp(dir=osp.dirname(osp.abspath(path)), suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    except BaseException:
        if osp.exists(tmp):
            os.unlink(tmp)
        raise


def load_pytree(path: str, template):
    """The tree saved at ``path``, shaped like ``template``: each leaf a
    tensor of the template leaf's dtype on its device. Raises for a missing
    leaf or a shape that differs."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}

    def pick(name, x):
        key = name.replace("/", SEP)
        if key not in flat:
            raise KeyError(f"checkpoint missing parameter {key}")
        v = flat[key]
        if tuple(v.shape) != tuple(x.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt {v.shape} vs {tuple(x.shape)}")
        return torch.from_numpy(v).to(device=x.device, dtype=x.dtype)

    return trees.named_tree_map(pick, template)


def save_decomposition(dirpath: str, shared, domain_specific: List[Any],
                       extra: Optional[Dict] = None, mask=None) -> None:
    """MAMDR's checkpoint: ``shared.npz``, ``specific_{i}.npz`` a domain and
    ``meta.json``. With ``mask`` (the meta-parameter mask) a specific file
    holds only the masked leaves: its other leaves alias the shared tree's
    (``MAMDRStrategy``), and at bench shapes writing them would put the
    frozen tables in every file."""
    os.makedirs(dirpath, exist_ok=True)
    save_pytree(osp.join(dirpath, "shared.npz"), shared)
    for i, spec in enumerate(domain_specific):
        save_pytree(osp.join(dirpath, f"specific_{i}.npz"), spec, keep=mask)
    meta = {"n_domain": len(domain_specific), "masked_only": mask is not None}
    if extra:
        meta.update(extra)
    with open(osp.join(dirpath, "meta.json"), "w") as f:
        json.dump(meta, f)
