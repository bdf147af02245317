"""Whole ``run()``s whose lanes take the autograd lane step, in the port vs
the JAX package's, by the recipe of tests/test_torch_zoo_run.py:

- ``deepfm_meta_mamdr_finetune`` and ``mmoe_meta_mamdr_finetune``: DN, DR
  with every query domain a lane (the port's lanes through
  ``apply_lanes``, the JAX package's vmapped), the merged eval, the best
  snapshot, test, and the SGD finetune as domain lanes;
- ``mlp_uncertainty_weight_finetune``: the uncertainty-weighted joint loop,
  then the finetune lanes, each lane with its own ``log_vars``.

Per-domain test loss within rtol 1e-4, AUC within abs 1e-5.
"""

import pytest
import torch

from mamdr_tpu_torch.strategies.joint import JointStrategy
from mamdr_tpu_torch.strategies.mamdr import MAMDRStrategy
from mamdr_tpu_torch.utils import trees
from test_torch_zoo_run import run_and_compare, zoo_pair

SETTINGS = [(True, False), (False, True)]


@pytest.mark.parametrize("long_tail,emb_trainable", SETTINGS)
@pytest.mark.parametrize("name", ["deepfm_meta_mamdr_finetune", "mmoe_meta_mamdr_finetune"])
def test_mamdr_run_matches_jax(tmp_path, name, long_tail, emb_trainable):
    pair = zoo_pair(tmp_path, name, long_tail, emb_trainable)
    start = list(pair[3].specific)
    _, js, _, ts = run_and_compare(pair, emb_trainable)
    assert type(ts) is MAMDRStrategy and ts.dr_lanes and js._dr_parallel_eligible()
    for d in range(3):  # every domain's specific weights moved, and are finite
        moved = [not torch.equal(a, b) for m, a, b in zip(
            trees.leaves(ts.mask), trees.leaves(ts.specific[d]), trees.leaves(start[d])) if m]
        assert any(moved), d
        assert all(bool(torch.isfinite(x).all()) for x in trees.leaves(ts.specific[d]))


@pytest.mark.parametrize("long_tail,emb_trainable", SETTINGS)
def test_uncertainty_finetune_run_matches_jax(tmp_path, long_tail, emb_trainable):
    _, _, tt, ts = run_and_compare(
        zoo_pair(tmp_path, "mlp_uncertainty_weight_finetune", long_tail, emb_trainable),
        emb_trainable)
    assert type(ts) is JointStrategy and "uncertainty" in tt.state.params
