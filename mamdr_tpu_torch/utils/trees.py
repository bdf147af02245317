"""Nested-dict parameter trees: names, name-filtered masks, tree maps.

The port keeps parameters as nested dicts of tensors keyed exactly like the
flax trees of the JAX package (``model/dnn/Dense_0/Dense_0/kernel``), so a
leaf's '/'-joined path is the same name in both frameworks. Leaves are
visited in JAX's order — dict keys sorted at every level — which is what
``jax.tree_util`` does for dicts; flat optimizer vectors therefore pack the
same leaves at the same offsets (train/flat_optimizer.py).

Masks are trees of python bools (reference meta_parms filters,
model_zoo/maml.py:153-179).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

Tree = Any


def leaves_with_names(tree: Tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in JAX leaf order (sorted keys at every level)."""
    if isinstance(tree, dict):
        out: List[Tuple[str, Any]] = []
        for k in sorted(tree):
            out.extend(leaves_with_names(tree[k], f"{prefix}{k}/"))
        return out
    return [(prefix[:-1], tree)]


def leaves(tree: Tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_names(tree)]


def named_tree_map(fn: Callable[..., Any], tree: Tree, *rest: Tree, prefix: str = "") -> Tree:
    """Map fn(path, leaf, *rest_leaves) over a nested dict; the result has
    the structure of ``tree`` (fresh dicts, leaves as fn returns them).
    Leaves are visited in JAX leaf order."""
    if isinstance(tree, dict):
        return {
            k: named_tree_map(fn, tree[k], *(r[k] for r in rest), prefix=f"{prefix}{k}/")
            for k in sorted(tree)
        }
    return fn(prefix[:-1], tree, *rest)


def tree_map(fn: Callable[..., Any], tree: Tree, *rest: Tree) -> Tree:
    return named_tree_map(lambda _, x, *r: fn(x, *r), tree, *rest)


def param_names(tree: Tree) -> List[str]:
    return [name for name, _ in leaves_with_names(tree)]


def unflatten(named: Dict[str, Any]) -> Tree:
    """{'a/b/c': leaf} -> {'a': {'b': {'c': leaf}}}."""
    out: Dict[str, Any] = {}
    for name, leaf in named.items():
        node = out
        parts = name.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return out


def meta_parm_mask(params: Tree, meta_parms: Sequence[str]) -> Tree:
    """Boolean mask tree selecting the strategy's meta parameters.

    Semantics mirror reference maml.py:153-179:
      - ``["all"]``        -> every trainable parameter
      - ``["all_hidden"]`` -> every parameter whose path does NOT contain "emb"
      - explicit list      -> parameters whose path contains ANY listed substring;
                              raises if a listed name matches nothing.
    """
    meta_parms = list(meta_parms)
    if meta_parms == ["all"]:
        return tree_map(lambda x: True, params)
    if meta_parms == ["all_hidden"]:
        return named_tree_map(lambda name, x: "emb" not in name, params)

    matched = {m: False for m in meta_parms}

    def select(name: str, x) -> bool:
        hit = False
        for m in meta_parms:
            if m in name:
                matched[m] = True
                hit = True
        return hit

    mask = named_tree_map(select, params)
    missing = [m for m, ok in matched.items() if not ok]
    if missing:
        raise ValueError(
            f"meta_parms {missing} matched no parameter; available: "
            f"{param_names(params)}"
        )
    return mask
