"""The port's embedding_lookup vs the JAX package's (clip semantics).

On CPU tensors the port runs the plain version; it must equal
jnp.take(mode="clip") exactly, out-of-range ids included. Kernel K2 against
the plain version on the card: test_torch_kernels_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamdr_tpu.ops.embedding_lookup import embedding_lookup as jax_lookup
from mamdr_tpu_torch.ops.embedding_lookup import embedding_lookup


def _inputs(n=100, d=16, b=64, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.normal(0, 1, (n, d)).astype(np.float32)
    ids = rng.integers(-20, n + 20, b).astype(np.int32)
    ids[:4] = [-1, n, -(2**31), 2**31 - 1]
    return table, ids


@pytest.mark.parametrize("shape", [(100, 16, 64), (30, 128, 1024), (5, 4, 6)])
def test_lookup_matches_jax_clip(shape):
    table, ids = _inputs(*shape)
    want = np.asarray(jax_lookup(jnp.asarray(table), jnp.asarray(ids)))
    got = embedding_lookup(torch.from_numpy(table), torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, want)  # a gather: exact
