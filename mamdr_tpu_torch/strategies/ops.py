"""Weight-space algebra for the strategy control plane.

Counterpart of ``mamdr_tpu/strategies/ops.py`` (load_masked, reptile_update,
delta_accumulate, scaled_add, merge_weights, specific_from_adapted,
dr_accumulate, tree_where_mask_zero, ema_accumulate, pcgrad_project,
tree_add_trees): masked leaf-wise ops over
parameter trees. Masks select the strategy's meta parameters
(utils.trees.meta_parm_mask) and are trees of python bools.

Every op returns a new tree and writes no tensor in place. That matters:
MAMDR's ``shared`` tree is the trainer's initial params, and each domain's
``specific`` tree aliases shared's unmasked leaves (strategies/mamdr.py); an
in-place update would silently rewrite them all. Unmasked leaves are passed
through by reference, so frozen tables are never copied.

The ops broadcast: with ``shared`` leaves [...] and lane-stacked ``specific``
leaves [L, ...] (the DR phase's query-domain lanes), ``merge_weights`` gives
the [L, ...] merged leaves, and ``reptile_update`` / ``specific_update``
work leaf-wise on whatever leading axes their operands share.

The meta-gradient ops (``ema_accumulate``, ``pcgrad_project``,
``tree_add_trees``) take gradient trees that may hold ``None`` at leaves
that carry no gradient (a frozen table, or a leaf outside the meta mask in
an accumulator); a ``None`` leaf passes through as ``None``.
"""

from __future__ import annotations

from typing import Any

import torch

from mamdr_tpu_torch.utils import trees

Tree = Any


def load_masked(params: Tree, source: Tree, mask: Tree) -> Tree:
    """SetVarOp equivalent: replace masked leaves of params with source's."""
    return trees.tree_map(lambda m, p, s: s if m else p, mask, params, source)


def reptile_update(meta: Tree, adapted: Tree, lr, mask: Tree) -> Tree:
    """meta += (adapted - meta) * lr on masked leaves
    (reference reptile.py:127-132, domain_negotiation.py:118-123)."""
    return trees.tree_map(
        lambda m, m_, a_: m_ + (a_ - m_) * lr if m else m_, mask, meta, adapted)


def delta_accumulate(acc: Tree, adapted: Tree, base: Tree, mask: Tree) -> Tree:
    """acc += adapted - base on masked leaves (batch Reptile, reference
    reptile.py:134-138); ``acc``'s unmasked leaves pass through."""
    return trees.tree_map(
        lambda m, c, a, b: c + (a - b) if m else c, mask, acc, adapted, base)


def scaled_add(target: Tree, delta: Tree, scale, mask: Tree) -> Tree:
    """target += delta * scale on masked leaves (reptile.py:140-142)."""
    return trees.tree_map(lambda m, t, d: t + d * scale if m else t, mask, target, delta)


def merge_weights(shared: Tree, specific: Tree, mask: Tree, method: str = "plus") -> Tree:
    """Merged = shared + specific (plus) or shared * specific (times) on
    masked leaves; unmasked leaves carry shared's values
    (reference specific_base_model.py:164-172)."""
    if method == "plus":
        return trees.tree_map(lambda m, s_, p_: s_ + p_ if m else s_, mask, shared, specific)
    if method == "times":
        return trees.tree_map(lambda m, s_, p_: s_ * p_ if m else s_, mask, shared, specific)
    raise ValueError(f"unknown merged_method {method!r}")


def specific_update(specific: Tree, adapted: Tree, merged: Tree, lr, mask: Tree) -> Tree:
    """specific += (adapted - merged) * lr on masked leaves: the DR phase's
    update of a query domain's specific weights after a support run
    (reference mamdr.py:93-101)."""
    return trees.tree_map(
        lambda m, sp, a, mg: sp + (a - mg) * lr if m else sp,
        mask, specific, adapted, merged)


def specific_from_adapted(adapted: Tree, merged: Tree, specific: Tree, mask: Tree) -> Tree:
    """specific = adapted - merged on masked leaves (MAMDR's
    finetune_every_epoch update, reference mamdr.py:168-171); unmasked
    leaves keep the old specific's."""
    return trees.tree_map(lambda m, sp, a, mg: (a - mg) if m else sp,
                          mask, specific, adapted, merged)


def dr_accumulate(acc: Tree, adapted: Tree, merged: Tree, shared: Tree, mask: Tree,
                  method: str = "plus") -> Tree:
    """MAMDR's batch-mode DR accumulation (reference mamdr.py:182-190) on
    masked leaves: plus, acc += adapted - merged; times, acc += (adapted -
    merged) * shared."""
    if method == "plus":
        return trees.tree_map(lambda m, c, a, mg: c + (a - mg) if m else c,
                              mask, acc, adapted, merged)
    if method == "times":
        return trees.tree_map(lambda m, c, a, mg, sh: c + (a - mg) * sh if m else c,
                              mask, acc, adapted, merged, shared)
    raise ValueError(f"unknown merged_method {method!r}")


def tree_where_mask_zero(tree: Tree, mask: Tree) -> Tree:
    """Zero out non-masked leaves (restrict grads to the meta subset)."""
    return trees.tree_map(lambda m, x: x if m else torch.zeros_like(x), mask, tree)


def ema_accumulate(acc: Tree, g: Tree, mask: Tree, momentum: float = 0.999) -> Tree:
    """acc = momentum*acc + (1-momentum)*g on masked leaves
    (average_meta_grad="moving_mean", reference maml.py:219-221)."""
    return trees.tree_map(
        lambda m, a, g_: a * momentum + g_ * (1.0 - momentum) if m and a is not None else a,
        mask, acc, g)


def pcgrad_project(query_grads: Tree, aux_grads: Tree, mode: str = "reference") -> Tree:
    """Project aux grads against query grads, rowwise over the last axis
    (JAX ``pcgrad_project``). mode="reference" reproduces the reference's
    deviation from the published PCGrad (reference pcgrad.py:152-160):
    project when dot > 0 and normalise by ||g_q||; mode="paper" projects
    when dot < 0 and normalises by ||g_q||^2. A row of norm 0 gets
    coefficient 0. Returns the projected aux grads."""
    if mode not in ("reference", "paper"):
        raise ValueError(f"unknown pcgrad mode {mode!r}")

    def leaf(gq, ga):
        if gq is None:
            return ga
        dot = torch.sum(gq * ga, dim=-1, keepdim=True)
        norm2 = torch.sum(gq * gq, dim=-1, keepdim=True)
        if mode == "reference":
            norm = torch.sqrt(norm2)
            coef = torch.where(norm > 0.0, dot / torch.clamp(norm, min=1e-30), 0.0)
            project = dot > 0.0
        else:
            coef = torch.where(norm2 > 0.0, dot / torch.clamp(norm2, min=1e-30), 0.0)
            project = dot < 0.0
        return torch.where(project, ga - coef * gq, ga)

    return trees.tree_map(leaf, query_grads, aux_grads)


def tree_add_trees(a: Tree, b: Tree) -> Tree:
    """a + b leaf by leaf; a ``None`` leaf of ``a`` stays ``None``."""
    return trees.tree_map(lambda x, y: None if x is None else x + y, a, b)
