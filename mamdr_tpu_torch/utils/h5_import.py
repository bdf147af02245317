"""Import/export reference Keras .h5 checkpoints for the WHOLE model zoo.

Counterpart of ``mamdr_tpu/utils/h5_import.py`` on the port's parameter
trees (nested dicts of tensors with the flax names and layouts,
``convert.py``), so the mapping below is the JAX package's, leaf for leaf:
a file either package exports, the other imports to the same values. Leaves
are named and visited through ``utils.trees`` (``leaves_with_names``) where
the JAX package uses ``jax.tree_util``; arrays cross as numpy. The
imported tree keeps each template leaf's dtype and device.

The reference persists weights with Keras ``save_weights`` HDF5
(reference model_zoo/base_model.py:177-178, per-domain finetune checkpoints
``domain_{idx}.h5`` specific_base_model.py:124-125). This maps those files
onto this framework's pytrees — and back — for all 11 base models, so a
reference-trained model can be evaluated here for direct A/B, and weights
trained here can be loaded by the reference's ``load_model``
(base_model.py:180-182). In a no-TF environment this is the only
cross-implementation parity instrument.

Layout handled: Keras save_weights HDF5 — root attr ``layer_names``, one
group per layer with attr ``weight_names`` (full names like
``sparse_emb_user_emb/user_emb/embeddings:0``, ``dnn/kernel0:0``,
``star_fcn/kernel_shared:0``) and one dataset per weight.

Name contract (reference -> flax), per family:

MLP family (reference deepctr.py:95-137 build_mlp + deepctr 0.9.0 layers):
  sparse_emb_<f>/<f>/embeddings          -> embedding/<f>      (f in user_emb,
                                            item_emb, domain_emb)
  linear0sparse_emb_<f>/<f>/embeddings   -> linear/linear_<f>  ([n,1] wide part
                                            of WDL/DeepFM/NFM/AutoInt/CCPM)
  dnn kernel<i>/bias<i>                  -> dnn/Dense_<i>/.../kernel|bias
  un-indexed dense kernel [h,1], no bias -> logit/.../kernel
  interacting_layer[_<i>] query|key|value|res -> interacting_<i>/<same>
  conv2d[_<i>] kernel|bias               -> conv_<i>/kernel|bias (NHWC both)
STAR (star_fcn.py:61-99):
  kernel_shared|bias_shared|kernel_specific|bias_specific (k-th FCN layer)
                                         -> k-th StarFCN's same-named leaf
DeepMTLCTR (deep_mtl_ctr.py:25-66; deepctr multitask model conventions —
this framework batches per-task weights on a leading task axis, so import
STACKS the reference's per-task layers and export SLICES them):
  bottom/expert/gate DNN layer           -> bottom_dnn|gate_dnn (shared)
  tower_domain_<k> kernel<i>/bias<i>     -> towers/tower_kernel_<i>[k] etc.
  per-task un-indexed dense [h,1]        -> towers/tower_logit[k] (file order
                                            = task order)
  expert_<e> kernel<i>/bias<i>           -> experts/expert_kernel_<i>[e]
  gate_softmax_domain_<k> kernel         -> gate_kernel[k]
  level_<l>_task_domain_<k>_expert_specific_<j> kernel0/bias0
                                         -> task_expert_kernel_<l>[k,j]
  level_<l>_expert_shared_<s> kernel0    -> shared_expert_kernel_<l>[s]
  level_<l>_gate_specific_domain_<k>     -> task_gate_kernel_<l>[k]
  level_<l>_gate_shared kernel           -> shared_gate_kernel_<l>

deepctr's auto-numbered Keras layer names (``dense``, ``dense_1``, …,
``conv2d_<i>``, ``interacting_layer_<i>``) depend on graph construction
order, so the importer matches those positionally (file order) rather than
by numeric suffix; explicitly-named layers match by pattern. One deliberate
delta is reported, never silently dropped: deepctr's MMoE has a gate DNN
PER task while this framework shares one ``gate_dnn`` across tasks
(mtl.py:131-136) — importing keeps task 0's gate DNN and reports the rest
in ``report["skipped"]``. Keras optimizer slots / PartitionedNorm moving
stats (flax batch_stats) are likewise reported, not dropped.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np
import torch

from mamdr_tpu_torch.utils import trees

_EMB_FIELDS = ("user_emb", "item_emb", "domain_emb")
_STAR_LEAVES = ("kernel_shared", "bias_shared", "kernel_specific",
                "bias_specific")


def _natkey(s: str):
    """Natural sort key: 'Dense_10' sorts after 'Dense_2'."""
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


def read_keras_h5(path: str) -> List[Tuple[str, np.ndarray]]:
    """[(full_weight_name, array)] in the file's layer order; falls back to
    a plain dataset walk for files without save_weights attrs."""
    import h5py

    out: List[Tuple[str, np.ndarray]] = []
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        layer_names = root.attrs.get("layer_names")
        if layer_names is not None:
            for lname in layer_names:
                lname = lname.decode() if isinstance(lname, bytes) else lname
                g = root[lname]
                for wname in g.attrs.get("weight_names", []):
                    wname = (
                        wname.decode() if isinstance(wname, bytes) else wname
                    )
                    out.append((f"{lname}//{wname}", np.asarray(g[wname])))
        else:
            def visit(name, obj):
                if isinstance(obj, h5py.Dataset):
                    out.append((name, np.asarray(obj)))

            root.visititems(visit)
    return out


def _base_name(full: str) -> str:
    leaf = full.split("/")[-1]
    return leaf[:-2] if leaf.endswith(":0") else leaf


def _layer_name(full: str) -> str:
    """The Keras layer group name ('dnn//dnn/kernel0:0' -> 'dnn')."""
    return full.split("//")[0] if "//" in full else full.split("/")[0]


def _np(leaf) -> np.ndarray:
    """A leaf (tensor or array) as a host numpy array."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten_sorted(tree):
    """(path, leaf as numpy) pairs in natural path order."""
    items = [(name, _np(leaf)) for name, leaf in trees.leaves_with_names(tree)]
    items.sort(key=lambda kv: _natkey(kv[0]))
    return items


def _top_module(path: str) -> str:
    """First path segment below the (optional) 'params' root."""
    parts = path.split("/")
    if parts and parts[0] == "params":
        parts = parts[1:]
    return parts[0] if parts else path


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

_MTL_BATCHED = re.compile(
    r"(tower_kernel|tower_bias|tower_logit|expert_kernel|expert_bias|"
    r"gate_kernel|task_expert_kernel|task_expert_bias|task_gate_kernel|"
    r"shared_expert_kernel|shared_expert_bias|shared_gate_kernel)(?:_(\d+))?$"
)


def export_reference_weights(h5_path: str, model_params) -> None:
    """Write the MODEL subtree as a reference-layout Keras .h5 (the inverse
    of import_reference_weights) covering all 11 zoo families: the layers of
    ``reference_layers``, one group each in their order."""
    import h5py

    grouped: Dict[str, List[Tuple[str, np.ndarray]]] = {}
    for lname, wname, arr in reference_layers(model_params):
        grouped.setdefault(lname, []).append((wname, arr))
    with h5py.File(h5_path, "w") as f:
        f.attrs["layer_names"] = [ln.encode() for ln in grouped]
        for lname, weights in grouped.items():
            g = f.create_group(lname)
            g.attrs["weight_names"] = [wn.encode() for wn, _ in weights]
            for wn, arr in weights:
                g.create_dataset(wn, data=arr)


def reference_layers(model_params) -> List[Tuple[str, str, np.ndarray]]:
    """The MODEL subtree as the reference's Keras weights: (layer name,
    weight name, array), grouped by layer in the order
    ``export_reference_weights`` writes them (the order ``read_keras_h5``
    lists a file's weights in). Batched MTL leaves are sliced into the reference's
    per-task/per-expert layers. Leaves outside every known family go under
    ``flax_extra`` (importable by this module, ignored by Keras
    name-matching loaders)."""
    ours = _flatten_sorted(model_params)
    # (layer, weight_name, value) triples; layer order = append order
    layers: List[Tuple[str, str, np.ndarray]] = []

    # Dense modules pair kernel/bias by PARENT path so a bias-free kernel is
    # identified structurally, not by global sort position (a model with
    # several bias-free kernels previously collided on 'dense/kernel:0').
    parents: Dict[str, Dict[str, Tuple[str, np.ndarray]]] = {}
    for path, leaf in ours:
        base = path.split("/")[-1]
        if base in ("kernel", "bias"):
            parent = path.rsplit("/", 1)[0]
            parents.setdefault(parent, {})[base] = (path, np.asarray(leaf))

    # per-top-module dense layer counters (dnn/bottom_dnn/gate_dnn -> idx)
    dense_idx: Dict[str, int] = {}
    logit_done = False
    handled = set()

    def mark(path):
        handled.add(path)

    for path, leaf in ours:
        base = path.split("/")[-1]
        top = _top_module(path)
        arr = np.asarray(leaf)
        mtl = _MTL_BATCHED.fullmatch(base)
        if base in _EMB_FIELDS:
            lname = f"sparse_emb_{base}"
            layers.append((lname, f"{lname}/{base}/embeddings:0", arr))
            mark(path)
        elif base.startswith("linear_") and base.endswith("_emb"):
            field = base[len("linear_"):]
            lname = f"linear0sparse_emb_{field}"
            layers.append((lname, f"{lname}/{field}/embeddings:0", arr))
            mark(path)
        elif top.startswith("interacting_") and base in (
                "query", "key", "value", "res"):
            i = int(top.split("_")[-1])
            lname = "interacting_layer" if i == 0 else f"interacting_layer_{i}"
            layers.append((lname, f"{lname}/{base}:0", arr))
            mark(path)
        elif top.startswith("conv_") and base in ("kernel", "bias"):
            i = int(top.split("_")[-1])
            lname = "conv2d" if i == 0 else f"conv2d_{i}"
            layers.append((lname, f"{lname}/{base}:0", arr))
            mark(path)
        elif base in _STAR_LEAVES:
            lname = ("auxiliary_net" if "auxiliary" in path.lower()
                     else "star_fcn_" + top.split("_")[-1])
            layers.append((lname, f"{lname}/{base}:0", arr))
            mark(path)
        elif mtl:
            kind, li = mtl.group(1), mtl.group(2)
            li = int(li) if li is not None else None
            if kind in ("tower_kernel", "tower_bias"):
                w = "kernel" if kind == "tower_kernel" else "bias"
                for k in range(arr.shape[0]):
                    lname = f"tower_domain_{k}"
                    layers.append((lname, f"{lname}/{w}{li}:0", arr[k]))
            elif kind == "tower_logit":
                for k in range(arr.shape[0]):
                    lname = "dense" if k == 0 else f"dense_{k}"
                    layers.append((lname, f"{lname}/kernel:0", arr[k]))
            elif kind in ("expert_kernel", "expert_bias"):
                w = "kernel" if kind == "expert_kernel" else "bias"
                for e in range(arr.shape[0]):
                    lname = f"expert_{e}"
                    layers.append((lname, f"{lname}/{w}{li}:0", arr[e]))
            elif kind == "gate_kernel":
                for k in range(arr.shape[0]):
                    lname = f"gate_softmax_domain_{k}"
                    layers.append((lname, f"{lname}/kernel:0", arr[k]))
            elif kind in ("task_expert_kernel", "task_expert_bias"):
                w = "kernel0" if kind.endswith("kernel") else "bias0"
                for k in range(arr.shape[0]):
                    for j in range(arr.shape[1]):
                        lname = f"level_{li}_task_domain_{k}_expert_specific_{j}"
                        layers.append((lname, f"{lname}/{w}:0", arr[k, j]))
            elif kind in ("shared_expert_kernel", "shared_expert_bias"):
                w = "kernel0" if kind.endswith("kernel") else "bias0"
                for s in range(arr.shape[0]):
                    lname = f"level_{li}_expert_shared_{s}"
                    layers.append((lname, f"{lname}/{w}:0", arr[s]))
            elif kind == "task_gate_kernel":
                for k in range(arr.shape[0]):
                    lname = f"level_{li}_gate_specific_domain_{k}"
                    layers.append((lname, f"{lname}/kernel:0", arr[k]))
            elif kind == "shared_gate_kernel":
                lname = f"level_{li}_gate_shared"
                layers.append((lname, f"{lname}/kernel:0", arr))
            mark(path)
        elif base == "kernel":
            parent = path.rsplit("/", 1)[0]
            pair = parents.get(parent, {})
            if "bias" in pair:
                # a hidden Dense layer of a DNN-style module. deepctr's
                # SharedBottom bottom DNN is the Keras-auto-named 'dnn'
                # layer; ours is 'bottom_dnn' — export the reference name.
                lname = "dnn" if top == "bottom_dnn" else top
                i = dense_idx.get(lname, 0)
                dense_idx[lname] = i + 1
                layers.append((lname, f"{lname}/kernel{i}:0", arr))
                bpath, barr = pair["bias"]
                layers.append((lname, f"{lname}/bias{i}:0", barr))
                mark(path)
                mark(bpath)
            else:
                # bias-free kernel: the logit head. A second one outside the
                # known families would collide — fail loud.
                if logit_done:
                    raise ValueError(
                        f"second bias-free Dense kernel at {path!r}; extend "
                        "the export name map for this architecture"
                    )
                layers.append(("dense", "dense/kernel:0", arr))
                logit_done = True
                mark(path)
        elif base == "bias":
            if path not in handled:
                parent = path.rsplit("/", 1)[0]
                if "kernel" in parents.get(parent, {}):
                    continue  # written alongside its kernel above
                layers.append(("flax_extra", f"flax_extra/{path}:0", arr))
                mark(path)
        else:
            layers.append(("flax_extra", f"flax_extra/{path}:0", arr))
            mark(path)
    # grouped by layer, each layer where its first weight came (a stable sort)
    first: Dict[str, int] = {}
    for lname, _, _ in layers:
        first.setdefault(lname, len(first))
    return sorted(layers, key=lambda t: first[t[0]])


# ---------------------------------------------------------------------------
# import
# ---------------------------------------------------------------------------

_RE_TOWER = re.compile(r"tower_domain_(\d+)")
_RE_EXPERT = re.compile(r"expert_(\d+)")
_RE_GATE_SOFTMAX = re.compile(r"gate_softmax_domain_(\d+)")
_RE_GATE_DNN = re.compile(r"gate_domain_(\d+)")
_RE_PLE_TASK = re.compile(r"level_(\d+)_task_domain_(\d+)_expert_specific_(\d+)")
_RE_PLE_SHARED = re.compile(r"level_(\d+)_expert_shared_(\d+)")
_RE_PLE_TGATE = re.compile(r"level_(\d+)_gate_specific_domain_(\d+)")
_RE_PLE_SGATE = re.compile(r"level_(\d+)_gate_shared")
_RE_INTERACT = re.compile(r"interacting_layer(?:_(\d+))?")
_RE_CONV = re.compile(r"conv2d(?:_(\d+))?")


def import_reference_weights(h5_path: str, model_params) -> Tuple[dict, dict]:
    """Returns (new_model_params, report). ``model_params`` is the MODEL
    subtree (``trainer.state.params["model"]``), a nested dict of tensors.
    Raises on shape mismatch of a matched weight; unmatched names go to
    report["skipped"]."""
    return import_weights(read_keras_h5(h5_path), model_params)


def import_weights(weights: List[Tuple[str, np.ndarray]], model_params) -> Tuple[dict, dict]:
    """``import_reference_weights`` on the weights of a file as
    ``read_keras_h5`` lists them: [("<layer>//<weight name>", array)] in
    file order."""
    ours = _flatten_sorted(model_params)

    # our buckets: final-leaf-name -> [(path, leaf)] in natural path order
    buckets: Dict[str, List[Tuple[str, np.ndarray]]] = {}
    by_path = dict(ours)
    for path, leaf in ours:
        buckets.setdefault(path.split("/")[-1], []).append((path, leaf))

    assignments: Dict[str, np.ndarray] = {}
    skipped: List[str] = []

    def assign(path: str, ref_name: str, arr: np.ndarray, want_shape):
        if tuple(arr.shape) != tuple(want_shape):
            raise ValueError(
                f"{ref_name}: shape {arr.shape} != flax {path} {want_shape}"
            )
        assignments[path] = arr

    def find_paths(pred):
        return [(p, l) for p, l in ours if pred(p)]

    # ---- pass 1: sort reference weights into family-specific pools --------
    dnn_groups: Dict[str, List[Tuple[str, str, np.ndarray]]] = {}
    plain_kernels: List[Tuple[str, np.ndarray]] = []   # un-indexed, file order
    star: Dict[Tuple[str, bool], List[Tuple[str, np.ndarray]]] = {}
    interact: Dict[int, List[Tuple[str, str, np.ndarray]]] = {}
    convs: Dict[int, List[Tuple[str, str, np.ndarray]]] = {}
    # stacked[target flax path] = {index tuple: (ref_name, arr)}
    stacked: Dict[str, Dict[tuple, Tuple[str, np.ndarray]]] = {}

    n_interact_seen = 0
    n_conv_seen = 0
    for full, arr in weights:
        lname = _layer_name(full)
        base = _base_name(full)
        m_kb = re.fullmatch(r"(kernel|bias)(\d+)", base)
        emb_field = next((e for e in _EMB_FIELDS if e in full), None)

        mi = _RE_INTERACT.fullmatch(lname)
        mc = _RE_CONV.fullmatch(lname)
        if base == "embeddings" and emb_field:
            linear = "linear" in lname
            target = f"linear_{emb_field}" if linear else emb_field
            lst = buckets.get(target, [])
            if len(lst) != 1:
                skipped.append(full)
            else:
                path, leaf = lst[0]
                assign(path, full, arr, np.asarray(leaf).shape)
        elif mi and base in ("query", "key", "value", "res"):
            i = int(mi.group(1) or 0)
            interact.setdefault(i, []).append((base, full, arr))
            n_interact_seen = max(n_interact_seen, i + 1)
        elif mc and base in ("kernel", "bias"):
            i = int(mc.group(1) or 0)
            convs.setdefault(i, []).append((base, full, arr))
            n_conv_seen = max(n_conv_seen, i + 1)
        elif _RE_TOWER.fullmatch(lname) and m_kb:
            k = int(_RE_TOWER.fullmatch(lname).group(1))
            li = int(m_kb.group(2))
            kind = "tower_kernel" if m_kb.group(1) == "kernel" else "tower_bias"
            stacked.setdefault(f"towers::{kind}_{li}", {})[(k,)] = (full, arr)
        elif _RE_EXPERT.fullmatch(lname) and m_kb:
            e = int(_RE_EXPERT.fullmatch(lname).group(1))
            li = int(m_kb.group(2))
            kind = ("expert_kernel" if m_kb.group(1) == "kernel"
                    else "expert_bias")
            stacked.setdefault(f"experts::{kind}_{li}", {})[(e,)] = (full, arr)
        elif _RE_GATE_SOFTMAX.fullmatch(lname) and base == "kernel":
            k = int(_RE_GATE_SOFTMAX.fullmatch(lname).group(1))
            stacked.setdefault("::gate_kernel", {})[(k,)] = (full, arr)
        elif _RE_PLE_TASK.fullmatch(lname) and m_kb:
            m = _RE_PLE_TASK.fullmatch(lname)
            lev, k, j = int(m.group(1)), int(m.group(2)), int(m.group(3))
            kind = ("task_expert_kernel" if m_kb.group(1) == "kernel"
                    else "task_expert_bias")
            stacked.setdefault(f"::{kind}_{lev}", {})[(k, j)] = (full, arr)
        elif _RE_PLE_SHARED.fullmatch(lname) and m_kb:
            m = _RE_PLE_SHARED.fullmatch(lname)
            lev, s = int(m.group(1)), int(m.group(2))
            kind = ("shared_expert_kernel" if m_kb.group(1) == "kernel"
                    else "shared_expert_bias")
            stacked.setdefault(f"::{kind}_{lev}", {})[(s,)] = (full, arr)
        elif _RE_PLE_TGATE.fullmatch(lname) and base == "kernel":
            m = _RE_PLE_TGATE.fullmatch(lname)
            lev, k = int(m.group(1)), int(m.group(2))
            stacked.setdefault(f"::task_gate_kernel_{lev}", {})[(k,)] = (
                full, arr)
        elif _RE_PLE_SGATE.fullmatch(lname) and base == "kernel":
            lev = int(_RE_PLE_SGATE.fullmatch(lname).group(1))
            target = find_paths(
                lambda p, lev=lev: p.split("/")[-1]
                == f"shared_gate_kernel_{lev}")
            if len(target) == 1:
                assign(target[0][0], full, arr,
                       np.asarray(target[0][1]).shape)
            else:
                skipped.append(full)
        elif _RE_GATE_DNN.fullmatch(lname) and m_kb:
            # deepctr has a gate DNN PER task; we share one gate_dnn — keep
            # task 0's, report the rest (module docstring).
            k = int(_RE_GATE_DNN.fullmatch(lname).group(1))
            if k == 0:
                dnn_groups.setdefault("gate_dnn", []).append(
                    (base, full, arr))
            else:
                skipped.append(full)
        elif m_kb:
            dnn_groups.setdefault(lname, []).append((base, full, arr))
        elif base == "kernel":
            plain_kernels.append((full, arr))
        elif base in _STAR_LEAVES:
            aux = "auxiliary" in full.lower()
            star.setdefault((base, aux), []).append((full, arr))
        else:
            skipped.append(full)

    # ---- pass 2: resolve pools against the flax tree ----------------------

    # DNN-style groups: match each reference group to our module whose top
    # segment has the same name; fall back to the single DNN module when the
    # names differ (the reference MLP's tower is always layer 'dnn').
    our_dense_parents: Dict[str, List[Tuple[str, str]]] = {}
    for path, leaf in ours:
        base = path.split("/")[-1]
        if base in ("kernel", "bias"):
            parent = path.rsplit("/", 1)[0]
            top = _top_module(path)
            if top.startswith(("interacting_", "conv_")) or top == "logit":
                continue
            our_dense_parents.setdefault(top, []).append((parent, base))

    def our_dnn_module(ref_name: str):
        if ref_name in our_dense_parents:
            return ref_name
        cands = [t for t in our_dense_parents
                 if t not in ("logit",) and not t.startswith("conv_")]
        if ref_name == "dnn" and "bottom_dnn" in cands:
            return "bottom_dnn"
        if len(cands) == 1:
            return cands[0]
        return None

    for ref_name, items in dnn_groups.items():
        top = our_dnn_module(ref_name)
        if top is None:
            skipped.extend(full for _, full, _ in items)
            continue
        ks = sorted((int(re.fullmatch(r"kernel(\d+)", b).group(1)), f, a)
                    for b, f, a in items if b.startswith("kernel"))
        bs = sorted((int(re.fullmatch(r"bias(\d+)", b).group(1)), f, a)
                    for b, f, a in items if b.startswith("bias"))
        mine_k = [(p, l) for p, l in ours
                  if _top_module(p) == top and p.endswith("/kernel")]
        mine_b = [(p, l) for p, l in ours
                  if _top_module(p) == top and p.endswith("/bias")]
        for refs, mine, kind in ((ks, mine_k, "kernel"), (bs, mine_b, "bias")):
            if len(refs) != len(mine):
                raise ValueError(
                    f"{ref_name} {kind} count mismatch: reference has "
                    f"{len(refs)}, flax module {top!r} has {len(mine)} "
                    f"({[p for p, _ in mine]})"
                )
            for (_, full, arr), (path, leaf) in zip(refs, mine):
                assign(path, full, arr, np.asarray(leaf).shape)

    # interacting layers: positional by layer index
    our_interact = sorted({_top_module(p) for p, _ in ours
                           if _top_module(p).startswith("interacting_")},
                          key=_natkey)
    for i, items in sorted(interact.items()):
        if i >= len(our_interact):
            skipped.extend(full for _, full, _ in items)
            continue
        top = our_interact[i]
        for base, full, arr in items:
            target = [(p, l) for p, l in ours
                      if _top_module(p) == top and p.endswith("/" + base)]
            if len(target) != 1:
                skipped.append(full)
                continue
            assign(target[0][0], full, arr, np.asarray(target[0][1]).shape)

    # conv layers: positional by layer index
    our_convs = sorted({_top_module(p) for p, _ in ours
                        if _top_module(p).startswith("conv_")}, key=_natkey)
    for i, items in sorted(convs.items()):
        if i >= len(our_convs):
            skipped.extend(full for _, full, _ in items)
            continue
        top = our_convs[i]
        for base, full, arr in items:
            target = [(p, l) for p, l in ours
                      if _top_module(p) == top and p.endswith("/" + base)]
            if len(target) != 1:
                skipped.append(full)
                continue
            assign(target[0][0], full, arr, np.asarray(target[0][1]).shape)

    # stacked MTL leaves: every slice must be present, then np.stack
    for key, pieces in stacked.items():
        mod, leafname = key.split("::")
        target = [(p, l) for p, l in ours
                  if p.split("/")[-1] == leafname
                  and (not mod or _top_module(p) == mod)]
        if len(target) != 1:
            skipped.extend(full for full, _ in pieces.values())
            continue
        path, leaf = target[0]
        want = np.asarray(leaf).shape
        rank = len(next(iter(pieces)))          # 1 (task/expert) or 2 (k,j)
        dims = want[:rank]
        expect = int(np.prod(dims))
        if len(pieces) != expect:
            raise ValueError(
                f"{leafname}: reference file has {len(pieces)} slices, "
                f"flax leaf {path} wants {expect} ({dims})"
            )
        out = np.zeros(want, np.asarray(leaf).dtype)
        for idx, (full, arr) in pieces.items():
            if tuple(arr.shape) != tuple(want[rank:]):
                raise ValueError(
                    f"{full}: slice shape {arr.shape} != flax {path} "
                    f"per-slice {want[rank:]}"
                )
            out[idx] = arr
        assignments[path] = out

    # plain (un-indexed, bias-free) kernels: single-tower models have exactly
    # one (the logit head); MTL models have one per task in file order
    # (Keras builds the task heads in task order).
    logit_paths = [(p, l) for p, l in ours
                   if p.endswith("/kernel") and _top_module(p) == "logit"]
    tower_logit = [(p, l) for p, l in ours
                   if p.split("/")[-1] == "tower_logit"]
    if plain_kernels:
        if logit_paths:
            if len(plain_kernels) != len(logit_paths):
                raise ValueError(
                    f"logit kernel count mismatch: reference has "
                    f"{len(plain_kernels)}, flax tree has {len(logit_paths)}"
                )
            for (full, arr), (path, leaf) in zip(plain_kernels, logit_paths):
                assign(path, full, arr, np.asarray(leaf).shape)
        elif tower_logit:
            path, leaf = tower_logit[0]
            want = np.asarray(leaf).shape
            if len(plain_kernels) != want[0]:
                raise ValueError(
                    f"per-task logit count mismatch: reference has "
                    f"{len(plain_kernels)}, flax tower_logit wants {want[0]}"
                )
            out = np.zeros(want, np.asarray(leaf).dtype)
            for k, (full, arr) in enumerate(plain_kernels):
                if tuple(arr.shape) != tuple(want[1:]):
                    raise ValueError(
                        f"{full}: shape {arr.shape} != flax {path} "
                        f"per-task {want[1:]}"
                    )
                out[k] = arr
            assignments[path] = out
        else:
            skipped.extend(full for full, _ in plain_kernels)

    # STAR FCN / auxiliary leaves: positional within each name
    for (base, aux), refs in star.items():
        mine = [
            (p, l) for p, l in buckets.get(base, [])
            if ("auxiliary" in p.lower()) == aux
        ]
        if len(refs) != len(mine):
            raise ValueError(
                f"{base}{' (auxiliary)' if aux else ''} count mismatch: "
                f"reference {len(refs)} vs flax {len(mine)}"
            )
        for (full, arr), (path, leaf) in zip(refs, mine):
            assign(path, full, arr, np.asarray(leaf).shape)

    # flax_extra round-trip (our own export's catch-all)
    for full, arr in list(weights):
        if _layer_name(full) == "flax_extra":
            inner = full.split("//", 1)[-1]
            inner = inner[len("flax_extra/"):]
            inner = inner[:-2] if inner.endswith(":0") else inner
            if inner in by_path and inner not in assignments:
                assign(inner, full, arr, np.asarray(by_path[inner]).shape)
                if full in skipped:
                    skipped.remove(full)

    matched = [n for n in trees.param_names(model_params) if n in assignments]
    new_params = trees.named_tree_map(
        lambda n, x: torch.as_tensor(np.asarray(assignments[n]), dtype=x.dtype, device=x.device)
        if n in assignments else x, model_params)
    report = {
        "matched": matched,
        "unmatched_flax": [p for p, _ in ours if p not in assignments],
        "skipped": skipped,
    }
    return new_params, report
