"""Whole ``run()``s of the MTL models (SharedBottom, MMoE, PLE) in the port
vs the JAX package's, by the recipe of tests/test_torch_zoo_run.py: each
domain's logit from its own task tower, at rtol 1e-4 on the per-domain test
loss and abs 1e-5 on the AUC, the early stop, the numpy draws and the
``metrics.jsonl`` events equal, frozen tables the same tensors."""

import pytest

from mamdr_tpu_torch.strategies.joint import JointStrategy
from test_torch_zoo_run import run_and_compare, zoo_pair

MTL = ["shared_bottom", "mmoe", "ple"]


@pytest.mark.parametrize("long_tail,emb_trainable", [(True, False), (False, True)])
@pytest.mark.parametrize("name", MTL)
def test_joint_run_matches_jax(tmp_path, name, long_tail, emb_trainable):
    _, _, _, ts = run_and_compare(zoo_pair(tmp_path, name, long_tail, emb_trainable),
                                  emb_trainable)
    assert type(ts) is JointStrategy
