"""Hash dropout masks of the port vs the JAX package: bit-identical.

The port computes murmur3 fmix32 in int64 with split 32-bit multiplies
(mamdr_tpu_torch/ops/fast_random.py); the JAX package in uint32. Same seed,
same shape -> the same uniforms bit for bit and the same keep masks, both
against ops.fast_random.dropout_mask and the Pallas kernel's _hash_keep.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamdr_tpu.ops import fast_random as jfr
from mamdr_tpu.ops.fused_mlp_step import _hash_keep
from mamdr_tpu_torch.ops import fast_random as tfr

SEEDS = [0, 1, 12345, 2**31 - 1, 2**31, 2**32 - 1, 0xDEADBEEF]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1024, 256), (7, 13)])
def test_hash_uniform_and_mask_bit_identical(seed, shape):
    u_j = np.asarray(jfr.hash_uniform(jnp.uint32(seed), shape))
    u_t = tfr.hash_uniform(seed, shape).numpy()
    np.testing.assert_array_equal(u_t.view(np.uint32), u_j.view(np.uint32))

    m_j = np.asarray(jfr.dropout_mask(jnp.uint32(seed), 0.5, shape))
    m_t = tfr.dropout_mask(seed, 0.5, shape).numpy()
    np.testing.assert_array_equal(m_t, m_j)
    # the Pallas kernel's mask (batch-global row*h + col counter)
    k_j = np.asarray(_hash_keep(jnp.uint32(seed), shape, 0.5))
    np.testing.assert_array_equal(m_t, k_j)


def test_mul32_matches_uint32_wraparound():
    """The split multiply equals uint32 multiplication mod 2**32 everywhere,
    including operands near 2**32 where a plain int64 product would overflow."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.integers(0, 2**32, 4096, dtype=np.uint64),
        np.array([0, 1, 2**31, 2**32 - 1], np.uint64),
    ]).astype(np.uint32)
    for c in (tfr.IOTA_MUL, tfr.MUL1, tfr.MUL2, 2**32 - 1):
        want = x * np.uint32(c)  # numpy uint32 wraps
        got = tfr.mul32(torch.from_numpy(x.astype(np.int64)), c).numpy()
        np.testing.assert_array_equal(got.astype(np.uint32), want)


def test_step_seeds_depend_on_step_and_layer():
    s0 = tfr.step_seeds(7, torch.tensor(0, dtype=torch.int32), 3)
    s1 = tfr.step_seeds(7, torch.tensor(1, dtype=torch.int32), 3)
    assert s0.dtype == torch.int64 and s0.shape == (3,)
    assert len(set(s0.tolist()) | set(s1.tolist())) == 6
    assert all(0 <= v < 2**32 for v in s0.tolist() + s1.tolist())
    np.testing.assert_array_equal(
        s0.numpy(), tfr.step_seeds(7, torch.tensor(0), 3).numpy())
