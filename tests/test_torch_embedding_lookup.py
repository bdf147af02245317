"""The port's embedding_lookup vs the JAX package's (clip semantics).

On CPU tensors the port runs the plain version; it must equal
jnp.take(mode="clip") exactly, out-of-range ids included. Kernel K2 against
the plain version on the card: test_torch_kernels_gpu.py.

``gather_rows_pipelined`` (kernel K3's wrapper) on CPU tensors against the
Pallas ring gather it replaces, run in interpret mode: exact, for any ring
depth k, including k 1 and k > B. (In-range ids only: the Pallas kernel does
not clip; the port's clamp is held to ``embedding_lookup``.) ``ring_plan`` is
kernel K3's launch in plain Python: how the rows are dealt over the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamdr_tpu.ops.embedding_lookup import embedding_lookup as jax_lookup
from mamdr_tpu.ops.embedding_lookup import pallas_gather_rows_pipelined
from mamdr_tpu_torch.ops.embedding_lookup import (
    RING_SHARED_BYTES_MAX,
    embedding_lookup,
    gather_rows_pipelined,
    ring_plan,
)


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


@pytest.mark.parametrize("k", [1, 4, 32, 100])
def test_pipelined_gather_matches_pallas_ring(k):
    rng = np.random.default_rng(k)
    table = rng.normal(0, 1, (200, 128)).astype(np.float32)
    ids = rng.integers(0, 200, 48).astype(np.int32)  # k = 100 > B = 48
    want = np.asarray(pallas_gather_rows_pipelined(
        jnp.asarray(table), jnp.asarray(ids), k=k, interpret=True))
    got = gather_rows_pipelined(torch.from_numpy(table), torch.from_numpy(ids), k=k)
    np.testing.assert_array_equal(got.numpy(), want)  # a gather: exact


@pytest.mark.parametrize("k", [1, 49, 1000])
@pytest.mark.parametrize("b", [1, 48])
def test_pipelined_gather_depth_one_and_beyond_the_batch(b, k):
    """k 1 (one copy in flight) and k larger than B (cut to B), down to a
    single id: exact against the Pallas ring in interpret mode."""
    rng = np.random.default_rng(100 * b + k)
    table = rng.normal(0, 1, (64, 128)).astype(np.float32)
    ids = rng.integers(0, 64, b).astype(np.int32)
    want = np.asarray(pallas_gather_rows_pipelined(
        jnp.asarray(table), jnp.asarray(ids), k=k, interpret=True))
    got = gather_rows_pipelined(torch.from_numpy(table), torch.from_numpy(ids), k=k)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("batch,k,blocks,rows,slots", [
    (1024, 32, 512, 2, 2), (1024, 128, 512, 2, 2), (30720, 32, 521, 59, 32),
    (30720, 128, 521, 59, 59), (1, 1, 1, 1, 1), (5, 32, 5, 1, 1), (30720, 1, 521, 59, 1)])
def test_ring_plan_deals_the_rows_over_the_card(batch, k, blocks, rows, slots):
    """Kernel K3's launch on a 132-SM card: a few blocks per SM cover the ids
    with contiguous runs of rows; a block's ring has min(k, its rows) slots."""
    plan = ring_plan(batch, k, 128, 132)
    assert (plan.blocks, plan.rows_per_block, plan.slots) == (blocks, rows, slots)
    assert plan.blocks * plan.rows_per_block >= batch > (plan.blocks - 1) * plan.rows_per_block
    assert plan.shared_bytes == slots * (128 * 4 + 8) <= RING_SHARED_BYTES_MAX
    if batch >= 1024:
        assert plan.blocks >= 64


def test_ring_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="multiple of 16"):
        ring_plan(1024, 32, 6, 132)       # a 24-byte row is no bulk copy
    with pytest.raises(ValueError, match="shared memory"):
        ring_plan(132 * 4 * 450, 450, 128, 132)  # 450 slots of 520 bytes: 234 KB
    with pytest.raises(ValueError):
        ring_plan(0, 32, 128, 132)


def test_pipelined_gather_clamps_and_checks_k():
    table, ids = _inputs()
    t, i = torch.from_numpy(table), torch.from_numpy(ids)
    assert torch.equal(gather_rows_pipelined(t, i, k=8), embedding_lookup(t, i))
    with pytest.raises(ValueError, match="k must be"):
        gather_rows_pipelined(t, i, k=0)


def test_table_rows_clips_per_lane():
    """The lane step's one lookup over ids flattened across lanes: on a table
    every lane shares, and on a lane-stacked table gathered as its [L*N, D]
    view, where an id past a lane's rows must give that lane's last row and
    never the next lane's first. Held to the JAX lookup (clip) lane by lane."""
    from mamdr_tpu_torch.ops.fused_mlp_step import table_rows

    rng = np.random.default_rng(3)
    lanes, n, d, b = 4, 5, 8, 12
    stack = rng.normal(0, 1, (lanes, n, d)).astype(np.float32)
    ids = rng.integers(0, n, (lanes, b)).astype(np.int32)
    ids[:, :5] = [-1, -(2**31), n, n + 1, 2**31 - 1]
    rows, flat = table_rows(torch.from_numpy(stack), torch.from_numpy(ids))
    assert rows.shape == (lanes, b, d) and flat.shape == (lanes * b,)
    for l in range(lanes):
        assert int(flat[l * b :(l + 1) * b].min()) >= l * n
        assert int(flat[l * b :(l + 1) * b].max()) < (l + 1) * n
        want = np.asarray(jax_lookup(jnp.asarray(stack[l]), jnp.asarray(ids[l])))
        np.testing.assert_array_equal(rows[l].numpy(), want)
    shared, flat = table_rows(torch.from_numpy(stack[0]), torch.from_numpy(ids))
    assert flat.shape == (lanes * b,) and torch.equal(flat, torch.from_numpy(ids).reshape(-1))
    want = np.asarray(jax_lookup(jnp.asarray(stack[0]), jnp.asarray(ids.reshape(-1))))
    np.testing.assert_array_equal(shared.numpy().reshape(-1, d), want)
    one, flat = table_rows(torch.from_numpy(stack[0]), torch.from_numpy(ids[0]))
    assert one.shape == (b, d) and torch.equal(flat, torch.from_numpy(ids[0]))
