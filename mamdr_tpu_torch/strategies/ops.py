"""Weight-space algebra for the strategy control plane.

Counterpart of ``mamdr_tpu/strategies/ops.py`` (load_masked, reptile_update,
merge_weights): masked leaf-wise ops over parameter trees. Masks select the
strategy's meta parameters (utils.trees.meta_parm_mask) and are trees of
python bools.

Every op returns a new tree and writes no tensor in place. That matters:
MAMDR's ``shared`` tree is the trainer's initial params, and each domain's
``specific`` tree aliases shared's unmasked leaves (strategies/mamdr.py); an
in-place update would silently rewrite them all. Unmasked leaves are passed
through by reference, so frozen tables are never copied.
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


def merge_weights(shared: Tree, specific: Tree, mask: Tree, method: str = "plus") -> Tree:
    """Merged = shared + specific (plus) or shared * specific (times) on
    masked leaves; unmasked leaves carry shared's values
    (reference specific_base_model.py:164-172)."""
    if method == "plus":
        return trees.tree_map(lambda m, s_, p_: s_ + p_ if m else s_, mask, shared, specific)
    if method == "times":
        return trees.tree_map(lambda m, s_, p_: s_ * p_ if m else s_, mask, shared, specific)
    raise ValueError(f"unknown merged_method {method!r}")
