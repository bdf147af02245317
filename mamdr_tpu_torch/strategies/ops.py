"""Weight-space algebra for the strategy control plane.

Counterpart of ``mamdr_tpu/strategies/ops.py`` (load_masked, reptile_update,
delta_accumulate, scaled_add, merge_weights): masked leaf-wise ops over parameter trees. Masks select the
strategy's meta parameters (utils.trees.meta_parm_mask) and are trees of
python bools.

Every op returns a new tree and writes no tensor in place. That matters:
MAMDR's ``shared`` tree is the trainer's initial params, and each domain's
``specific`` tree aliases shared's unmasked leaves (strategies/mamdr.py); an
in-place update would silently rewrite them all. Unmasked leaves are passed
through by reference, so frozen tables are never copied.

The ops broadcast: with ``shared`` leaves [...] and lane-stacked ``specific``
leaves [L, ...] (the DR phase's query-domain lanes), ``merge_weights`` gives
the [L, ...] merged leaves, and ``reptile_update`` / ``specific_update``
work leaf-wise on whatever leading axes their operands share.
"""

from __future__ import annotations

from typing import Any

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
