"""Keras .h5 import / export (``mamdr_tpu_torch/utils/h5_import.py``) vs the
JAX package's (``mamdr_tpu/utils/h5_import.py``), on the cases of
tests/test_h5_import.py and tiny files written here in the Keras
``save_weights`` layout with the reference's weight names.

Each case gives both packages the same file and the same parameter tree
(the flax model's init, carried over by ``convert.params_from_jax``): the
imported trees are equal leaf by leaf, bit for bit, and the reports
(matched, unmatched, skipped) equal — the MLP with Keras noise, the MMoE
reference layout (stacked towers, experts and gates; task 0's gate DNN
kept and the others reported), the AutoInt and CCPM layouts (matched by
position), STAR's FCN leaves with a PartitionedNorm's moving statistics
(reported, not imported); a shape mismatch raises in both. For all eleven
base models each package's export is read by the other's import (and its
own) back to the same tree, and the two exports hold the same layers and
weights; ``import_weights`` on ``reference_layers`` (the round trip without
a file, which needs no h5py) gives the same tree and report. Imported
weights drive an evaluation in the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")

from mamdr_tpu.config import ExperimentConfig as JConfig  # noqa: E402
from mamdr_tpu.models.zoo import build_model as jax_build_model  # noqa: E402
from mamdr_tpu.utils import h5_import as jh5  # noqa: E402
from mamdr_tpu.utils import trees as jtrees  # noqa: E402
from mamdr_tpu_torch.config import ExperimentConfig  # noqa: E402
from mamdr_tpu_torch.convert import params_from_jax  # noqa: E402
from mamdr_tpu_torch.data.synthetic import make_synthetic_dataset  # noqa: E402
from mamdr_tpu_torch.train.trainer import Trainer  # noqa: E402
from mamdr_tpu_torch.utils import h5_import, trees  # noqa: E402

ZOO = [
    ("mlp", {}),
    ("wdl", {}),
    ("deepfm", {}),
    ("nfm", {}),
    ("autoint", {}),
    ("ccpm", {}),
    ("pnn", {}),
    ("shared_bottom", {"tower_hidden_dim": [8]}),
    ("mmoe", {"tower_hidden_dim": [8], "num_experts": 2, "gate_dnn_hidden_units": [8]}),
    ("ple", {"tower_hidden_dim": [8], "specific_expert_num": 2, "shared_expert_num": 1,
             "num_levels": 2}),
    ("star", {"norm": "pn", "dense": "star", "auxiliary_net": True, "auxiliary_dim": 8}),
]
EXTRA = dict(ZOO)


def write_keras_h5(path, layers):
    """layers: [(layer_name, [(weight_name, array), ...])] in layer order."""
    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = [ln.encode() for ln, _ in layers]
        for ln, weights in layers:
            g = f.create_group(ln)
            g.attrs["weight_names"] = [wn.encode() for wn, _ in weights]
            for wn, arr in weights:
                g.create_dataset(wn, data=arr)


def _cfg(tmp_path, name):
    return {"model": {"name": name, "user_dim": 8, "item_dim": 8, "domain_dim": 8,
                      "hidden_dim": [16, 8], "dropout": 0.0, **EXTRA[name]},
            "train": {"epoch": 1, "metrics_jsonl": False,
                      "checkpoint_path": str(tmp_path / "c"),
                      "result_save_path": str(tmp_path / "r")},
            "dataset": {"name": "synthetic", "batch_size": 64, "seed": 3}}


def _pair(tmp_path, name):
    """(the flax model's init tree as numpy, the same tree in the port)."""
    model = jax_build_model(JConfig.from_dict(_cfg(tmp_path, name)), 40, 40, 3)
    ids = jnp.zeros((4,), jnp.int32)
    jmodel = jax.device_get(jax.jit(model.init)({"params": jax.random.PRNGKey(3)}, ids, ids, ids)[
        "params"])
    jmodel = jax.tree_util.tree_map(np.asarray, jmodel)
    return jmodel, params_from_jax(jmodel)


def _same_tree(port_tree, jax_tree, what):
    jn = dict(zip(jtrees.param_names(jax_tree), jax.tree_util.tree_leaves(jax_tree)))
    assert trees.param_names(port_tree) == list(jn), what
    for n, x in trees.leaves_with_names(port_tree):
        assert x.dtype == torch.float32, n
        np.testing.assert_array_equal(x.numpy(), np.asarray(jn[n]), err_msg=f"{what}: {n}")


def _import_both(path, jmodel, tmodel):
    jnew, jrep = jh5.import_reference_weights(path, jmodel)
    tnew, trep = h5_import.import_reference_weights(path, tmodel)
    _same_tree(tnew, jax.device_get(jnew), path)
    assert trep == jrep
    return tnew, trep


def _like(rng, x):
    return rng.normal(0, 0.1, tuple(x.shape)).astype(np.float32)


def _mlp_layers(rng, m):
    dnn = [m["dnn"][k]["Dense_0"] for k in sorted(m["dnn"])]
    return [
        *[(f"sparse_emb_{f}", [(f"sparse_emb_{f}/{f}/embeddings:0",
                                _like(rng, m["embedding"][f]))])
          for f in ("user_emb", "item_emb", "domain_emb")],
        ("dnn", [(f"dnn/kernel{i}:0", _like(rng, d["kernel"])) for i, d in enumerate(dnn)]
         + [(f"dnn/bias{i}:0", _like(rng, d["bias"])) for i, d in enumerate(dnn)]),
        ("dense", [("dense/kernel:0", _like(rng, m["logit"]["Dense_0"]["Dense_0"]["kernel"]))]),
        # Keras noise both skip and report
        ("prediction_layer", [("prediction_layer/global_step:0", np.zeros((1,), np.float32))]),
    ]


def _mmoe_layers(rng, m):
    t, e = m["towers"]["tower_kernel_0"].shape[0], m["experts"]["expert_kernel_0"].shape[0]
    layers = [(f"expert_{j}", [(f"expert_{j}/{w}{i}:0",
                                _like(rng, m["experts"][f"expert_{w}_{i}"][j]))
                               for i in range(2) for w in ("kernel", "bias")])
              for j in range(e)]
    for k in range(t):
        layers += [
            (f"tower_domain_{k}", [(f"tower_domain_{k}/{w}0:0",
                                    _like(rng, m["towers"][f"tower_{w}_0"][k]))
                                   for w in ("kernel", "bias")]),
            (f"gate_softmax_domain_{k}", [(f"gate_softmax_domain_{k}/kernel:0",
                                           _like(rng, m["gate_kernel"][k]))]),
            ("dense" if k == 0 else f"dense_{k}",
             [(f"{'dense' if k == 0 else f'dense_{k}'}/kernel:0",
               _like(rng, m["towers"]["tower_logit"][k]))]),
            (f"gate_domain_{k}", [(f"gate_domain_{k}/{w}0:0",
                                   _like(rng, m["gate_dnn"]["Dense_0"]["Dense_0"][w]))
                                  for w in ("kernel", "bias")]),
        ]
    return layers


def _positional_layers(rng, m, name):
    if name == "autoint":
        mods = sorted((k for k in m if k.startswith("interacting_")),
                      key=lambda k: int(k.split("_")[-1]))
        return [("interacting_layer" if i == 0 else f"interacting_layer_{i}",
                 [(f"{'interacting_layer' if i == 0 else f'interacting_layer_{i}'}/{w}:0",
                   _like(rng, m[mod][w])) for w in ("query", "key", "value", "res")])
                for i, mod in enumerate(mods)]
    mods = sorted((k for k in m if k.startswith("conv_")), key=lambda k: int(k.split("_")[-1]))
    return [("conv2d" if i == 0 else f"conv2d_{i}",
             [(f"{'conv2d' if i == 0 else f'conv2d_{i}'}/{w}:0", _like(rng, m[mod][w]))
              for w in ("kernel", "bias")]) for i, mod in enumerate(mods)]


def _star_layers(rng, m):
    leaves = {}
    for n, x in trees.leaves_with_names(m):
        base = n.split("/")[-1]
        if base.endswith(("_shared", "_specific")) and "auxiliary" not in n:
            leaves.setdefault(base, []).append(x)
    layers = [(f"star_fcn_{i}", [(f"star_fcn_{i}/{b}:0", _like(rng, leaves[b][i]))
                                 for b in ("kernel_specific", "bias_specific",
                                           "kernel_shared", "bias_shared")])
              for i in range(len(leaves["kernel_shared"]))]
    return layers + [("partitioned_norm", [
        ("partitioned_norm/moving_mean:0", np.zeros((3, 24), np.float32)),
        ("partitioned_norm/moving_variance:0", np.ones((3, 24), np.float32))])]


CASES = {
    "mlp": lambda rng, m: _mlp_layers(rng, m),
    "mmoe": lambda rng, m: _mmoe_layers(rng, m),
    "autoint": lambda rng, m: _positional_layers(rng, m, "autoint"),
    "ccpm": lambda rng, m: _positional_layers(rng, m, "ccpm"),
    "star": lambda rng, m: _star_layers(rng, m),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_import_matches_jax(tmp_path, name):
    jmodel, tmodel = _pair(tmp_path, name)
    path = str(tmp_path / f"{name}_ref.h5")
    layers = CASES[name](np.random.default_rng(7), tmodel)
    write_keras_h5(path, layers)
    tnew, report = _import_both(path, jmodel, tmodel)
    written = {wn: a for _, ws in layers for wn, a in ws}
    if name == "mlp":
        np.testing.assert_array_equal(tnew["embedding"]["user_emb"].numpy(),
                                      written["sparse_emb_user_emb/user_emb/embeddings:0"])
        assert report["skipped"] == ["prediction_layer//prediction_layer/global_step:0"]
        assert not report["unmatched_flax"]
        # imported weights drive an evaluation
        tt = Trainer(ExperimentConfig.from_dict(_cfg(tmp_path, name)),
                     make_synthetic_dataset(n_domain=3, n_uid=40, n_pid=40, n_per_domain=200,
                                            seed=3, batch_size=64), device="cpu", verbose=False)
        tt.state = tt.state.replace(params={**tt.state.params, "model": tnew})
        loss, auc = tt.evaluate_domain("val", 0, tt.state.params, tt.state.batch_stats)
        assert np.isfinite(loss) and 0.0 <= auc <= 1.0
    elif name == "mmoe":
        np.testing.assert_array_equal(tnew["towers"]["tower_logit"][1].numpy(),
                                      written["dense_1/kernel:0"])
        assert any("gate_domain_1" in s for s in report["skipped"])
        assert all("emb" in p for p in report["unmatched_flax"])
    elif name == "star":
        assert {s.split("//")[0] for s in report["skipped"]} == {"partitioned_norm"}
    else:
        assert not report["skipped"]
    assert report["matched"]


def test_shape_mismatch_raises_in_both(tmp_path):
    jmodel, tmodel = _pair(tmp_path, "mlp")
    path = str(tmp_path / "bad.h5")
    write_keras_h5(path, [("sparse_emb_user_emb", [
        ("sparse_emb_user_emb/user_emb/embeddings:0", np.zeros((7, 3), np.float32))])])
    for module, tree in ((jh5, jmodel), (h5_import, tmodel)):
        with pytest.raises(ValueError, match="shape"):
            module.import_reference_weights(path, tree)


@pytest.mark.parametrize("name", [z[0] for z in ZOO])
def test_exports_read_both_ways(tmp_path, name):
    jmodel, tmodel = _pair(tmp_path, name)
    jpath, tpath = str(tmp_path / "jax.h5"), str(tmp_path / "port.h5")
    jh5.export_reference_weights(jpath, jmodel)
    h5_import.export_reference_weights(tpath, tmodel)
    jw, tw = jh5.read_keras_h5(jpath), h5_import.read_keras_h5(tpath)
    assert [n for n, _ in tw] == [n for n, _ in jw]
    for (n, a), (_, b) in zip(tw, jw):
        np.testing.assert_array_equal(a, b, err_msg=n)
    for path in (jpath, tpath):
        tnew, report = _import_both(path, jmodel, tmodel)
        _same_tree(tnew, jmodel, f"{name} round trip")
        assert not report["unmatched_flax"] and not report["skipped"], report
    # the same round trip without a file: the layers export writes, as
    # read_keras_h5 lists a file's weights
    listed = [(f"{lname}//{wname}", arr)
              for lname, wname, arr in h5_import.reference_layers(tmodel)]
    assert [n for n, _ in listed] == [n for n, _ in tw]
    tnew, report = h5_import.import_weights(listed, tmodel)
    _same_tree(tnew, jmodel, f"{name} round trip in memory")
    assert report == h5_import.import_reference_weights(tpath, tmodel)[1]
