"""Checkpoints: atomic npz snapshots of parameter trees and of a run.

Counterpart of ``mamdr_tpu/train/checkpoints.py`` (``save_pytree`` /
``load_pytree`` :26-73, the resume snapshot ``save_train_state`` /
``has_train_state`` / ``load_train_state`` :75-149, ``save_decomposition`` /
``load_decomposition`` :152-197), in the same file format: one npz array per
leaf, keyed by its flax path with ``//`` between the names
(``model//dnn//Dense_0//Dense_0//kernel``), written to a temporary file and
renamed into place. A file either package writes, the other reads. An
optimizer state (a NamedTuple such as ``FlatAdamState``) is stored as the
tree of its fields (``opt_state//mu``), as ``jax.tree_util`` names them.

The resume snapshot keeps the JAX layout: ``train_state.npz`` (``params``,
``opt_state``, ``batch_stats``, ``step``), one ``{name}.npz`` per extra tree
and ``resume_meta.json`` (``epoch``, ``stopper``, ``np_rng_state``,
``extra_trees``). The JAX state's PRNG keys (``rng``, ``host_rng``) have no
counterpart; the port stores instead, under keys of its own in
``train_state.npz``, the base dropout seed (``seed``) and the byte states of
its torch generators (``generator//<name>``). The JAX package's
``load_pytree`` reads the ``params`` / ``batch_stats`` / ``step`` subtree of
the port's file with a template of those keys.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from mamdr_tpu_torch.utils import trace, trees

SEP = "//"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _as_dicts(tree):
    """``tree`` with every NamedTuple (an optimizer state) as the dict of
    its fields, so its leaves get the names jax.tree_util gives them."""
    if _is_namedtuple(tree):
        return {k: _as_dicts(v) for k, v in tree._asdict().items()}
    if isinstance(tree, dict):
        return {k: _as_dicts(v) for k, v in tree.items()}
    return tree


def _like(template, loaded):
    """``loaded`` (the dicts of ``_as_dicts(template)``) rebuilt with the
    template's NamedTuples."""
    if _is_namedtuple(template):
        return type(template)(**{k: _like(getattr(template, k), loaded[k])
                                 for k in template._fields})
    if isinstance(template, dict):
        return {k: _like(v, loaded[k]) for k, v in template.items()}
    return loaded


def _flatten(tree) -> Dict[str, np.ndarray]:
    """``tree``'s leaves on the host, by name: one wait on the card
    (``host_syncs`` counts a tree once)."""
    trace.count("host_syncs")
    return {name.replace("/", SEP): (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                                     else np.asarray(x))
            for name, x in trees.leaves_with_names(_as_dicts(tree))}


def save_pytree(path: str, tree, keep=None) -> None:
    """Atomic npz write of ``tree``'s leaves; ``keep`` (a tree of bools of
    the same structure) leaves out the leaves it marks False."""
    flat = _flatten(tree)
    if keep is not None:
        keep_flat = _flatten(keep)
        flat = {k: v for k, v in flat.items() if bool(keep_flat[k])}
    _write_npz(path, flat)


def _write_npz(path: str, flat: Dict[str, np.ndarray]) -> None:
    """Write ``flat`` to ``path`` through a temporary file renamed into place."""
    os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
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
    return _unflatten_into(template, flat)


def _pick(flat: Dict[str, np.ndarray], name: str, x: torch.Tensor) -> torch.Tensor:
    """The value of leaf ``name`` in ``flat`` as a tensor like ``x``."""
    key = name.replace("/", SEP)
    if key not in flat:
        raise KeyError(f"checkpoint missing parameter {key}")
    v = flat[key]
    if tuple(v.shape) != tuple(x.shape):
        raise ValueError(f"shape mismatch for {key}: ckpt {v.shape} vs {tuple(x.shape)}")
    return torch.from_numpy(v).to(device=x.device, dtype=x.dtype)


def _unflatten_into(template, flat: Dict[str, np.ndarray]):
    """``template``'s structure with the values of ``flat`` (template-driven:
    keys the template does not name are ignored)."""
    return _like(template, trees.named_tree_map(lambda n, x: _pick(flat, n, x),
                                                _as_dicts(template)))


def _state_tree(state) -> Dict[str, Any]:
    return {"params": state.params, "opt_state": state.opt_state,
            "batch_stats": state.batch_stats, "step": state.step}


def save_train_state(dirpath: str, state, epoch: int, stopper, np_rng,
                     extra_trees: Optional[Dict[str, Any]] = None,
                     generators: Optional[Dict[str, torch.Generator]] = None) -> None:
    """Atomic snapshot of everything a run needs to go on: the state's
    params, optimizer slots, batch statistics, step and base dropout seed,
    the early stop's counters, ``np_rng``'s bit-generator state, the byte
    state of each torch generator in ``generators``, and the strategy's
    ``extra_trees`` (JAX ``save_train_state``, checkpoints.py:75-122)."""
    os.makedirs(dirpath, exist_ok=True)
    flat = _flatten(_state_tree(state))
    flat["seed"] = np.asarray(int(state.seed), np.int64)
    for name, gen in (generators or {}).items():
        flat[f"generator{SEP}{name}"] = gen.get_state().numpy()
    _write_npz(osp.join(dirpath, "train_state.npz"), flat)
    for name, tree in (extra_trees or {}).items():
        save_pytree(osp.join(dirpath, f"{name}.npz"), tree)
    meta = {
        "epoch": epoch,
        "stopper": {"patience": stopper.patience, "counter": stopper.counter,
                    "best_metric": stopper.best_metric, "early_stop": stopper.early_stop},
        "np_rng_state": np_rng.bit_generator.state,
        "extra_trees": sorted((extra_trees or {}).keys()),
    }
    tmp = osp.join(dirpath, "resume_meta.json.tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, osp.join(dirpath, "resume_meta.json"))


def has_train_state(dirpath: str) -> bool:
    return (osp.exists(osp.join(dirpath, "resume_meta.json"))
            and osp.exists(osp.join(dirpath, "train_state.npz")))


def load_train_state(dirpath: str, state_template, extra_templates=None):
    """-> (state, epoch, stopper dict, np_rng state, extras): the state
    rebuilt on ``state_template``'s structure, dtypes and devices (its seed
    the saved one), and ``extras`` holding each extra tree of
    ``extra_templates`` whose file exists, plus ``"generators"``: {name:
    the saved byte state} (JAX ``load_train_state``, checkpoints.py:125-149)."""
    with open(osp.join(dirpath, "resume_meta.json")) as f:
        meta = json.load(f)
    with np.load(osp.join(dirpath, "train_state.npz")) as z:
        flat = {k: z[k] for k in z.files}
    loaded = _unflatten_into(_state_tree(state_template), flat)
    state = state_template.replace(seed=int(flat["seed"]), **loaded)
    prefix = f"generator{SEP}"
    extras: Dict[str, Any] = {"generators": {
        k[len(prefix):]: torch.from_numpy(v) for k, v in flat.items() if k.startswith(prefix)}}
    for name, template in (extra_templates or {}).items():
        p = osp.join(dirpath, f"{name}.npz")
        if osp.exists(p):
            extras[name] = load_pytree(p, template)
    return state, meta["epoch"], meta["stopper"], meta["np_rng_state"], extras


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


def load_decomposition(dirpath: str, template):
    """-> (shared, [specific_i], meta) of a ``save_decomposition`` folder,
    each tree shaped like ``template``; a specific file holding only the
    masked leaves takes its other leaves from the shared tree, which they
    alias (JAX ``load_decomposition``, checkpoints.py:179-197)."""
    with open(osp.join(dirpath, "meta.json")) as f:
        meta = json.load(f)
    shared = load_pytree(osp.join(dirpath, "shared.npz"), template)

    def load_spec(path):
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        return trees.named_tree_map(
            lambda n, x, s: _pick(flat, n, x) if n.replace("/", SEP) in flat else s,
            template, shared)

    specific = [load_spec(osp.join(dirpath, f"specific_{i}.npz"))
                for i in range(meta["n_domain"])]
    return shared, specific, meta
