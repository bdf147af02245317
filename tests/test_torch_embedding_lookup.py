"""The port's embedding lookups vs the JAX package's (clip semantics).

On CPU tensors the port runs the plain versions; they must equal
jnp.take(mode="clip") exactly, out-of-range ids included. ``gather_fields``
(kernel K2's wrapper: every field's rows into the tower input in one launch)
is held to ``jnp.concatenate`` of the JAX package's ``embedding_lookup``s,
for one tower and for lanes with shared and lane-stacked tables; the flat
row ids it returns to ``table_rows``'; its gradient (the model's, through
``make_loss_fn``) to ``jax.grad`` through the clip; ``field_plan`` is K2's
launch in plain Python. Kernel K2 against the plain version on the card:
test_torch_kernels_gpu.py.

``gather_rows_pipelined`` (kernel K3's wrapper) on CPU tensors against the
Pallas ring gather it replaces, run in interpret mode: exact, for any ring
depth k, including k 1 and k > B. (In-range ids only: the Pallas kernel does
not clip; the port's clamp is held to ``embedding_lookup``.) ``ring_plan`` is
kernel K3's launch in plain Python: how the rows are dealt over the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamdr_tpu.ops.embedding_lookup import embedding_lookup as jax_lookup
from mamdr_tpu.ops.embedding_lookup import pallas_gather_rows_pipelined
from mamdr_tpu.utils import trees as jtrees
from mamdr_tpu_torch.ops.embedding_lookup import (
    K2_MAX_FIELDS,
    RING_SHARED_BYTES_MAX,
    embedding_lookup,
    field_plan,
    gather_fields,
    gather_fields_reference,
    gather_rows_pipelined,
    ring_plan,
    table_rows,
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
    never the next lane's first; the flat row ids are clamped on both (a
    scatter-add of the gradient takes them). Held to the JAX lookup (clip)
    lane by lane."""
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
    assert flat.shape == (lanes * b,) and flat.dtype == torch.int32
    assert torch.equal(flat, torch.from_numpy(np.clip(ids, 0, n - 1)).reshape(-1))
    want = np.asarray(jax_lookup(jnp.asarray(stack[0]), jnp.asarray(ids.reshape(-1))))
    np.testing.assert_array_equal(shared.numpy().reshape(-1, d), want)
    one, flat = table_rows(torch.from_numpy(stack[0]), torch.from_numpy(ids[0]))
    assert one.shape == (b, d) and torch.equal(flat, torch.from_numpy(np.clip(ids[0], 0, n - 1)))


EDGE_IDS = lambda n: [-1, -(2**31), n, n + 5, 2**31 - 1]  # noqa: E731


def _fields(lanes, stacked, widths=(8, 12, 16), rows=(40, 30, 5), b=24, seed=0):
    """Tables and int32 ids of ``len(widths)`` fields: for one tower (lanes
    None: tables [N, D], ids [B]) or for L lanes (ids [L, B]; a table [N, D]
    every lane reads, or [L, N, D] where ``stacked`` says so). Every lane
    has each edge id of EDGE_IDS."""
    rng = np.random.default_rng(seed)
    tables, ids = [], []
    for d, n, st in zip(widths, rows, stacked):
        shape = (lanes, n, d) if st else (n, d)
        tables.append(rng.normal(0, 1, shape).astype(np.float32))
        i = rng.integers(0, n, (lanes or 1, b)).astype(np.int32)
        i[:, :5] = EDGE_IDS(n)
        ids.append(i if lanes else i[0])
    return tables, ids


def _jax_concat(tables, ids):
    """jnp.concatenate of the JAX package's lookups, lane by lane."""
    parts = []
    for t, i in zip(tables, ids):
        if i.ndim == 1:
            parts.append(np.asarray(jax_lookup(jnp.asarray(t), jnp.asarray(i))))
        else:
            parts.append(np.stack([np.asarray(jax_lookup(jnp.asarray(t[l] if t.ndim == 3 else t),
                                                         jnp.asarray(i[l])))
                                   for l in range(i.shape[0])]))
    return np.asarray(jnp.concatenate([jnp.asarray(p) for p in parts], axis=-1))


@pytest.mark.parametrize("lanes,stacked", [
    (None, (False, False, False)),   # one tower: the DN step
    (3, (False, False, True)),       # lanes: frozen shared tables, the domain table a lane
    (3, (True, True, True)),         # lanes with every table training
    (3, (False,)),                   # one field over lanes
    (None, (False,) * K2_MAX_FIELDS),
])
def test_gather_fields_matches_jax_concat(lanes, stacked):
    widths = (8, 12, 16, 4)[: len(stacked)]
    rows = (40, 30, 5, 7)[: len(stacked)]
    tables, ids = _fields(lanes, stacked, widths, rows)
    want = _jax_concat(tables, ids)
    tt = [torch.from_numpy(t) for t in tables]
    ti = [torch.from_numpy(i) for i in ids]
    x, flats = gather_fields(tt, ti, train_mask=[True] * len(tt))
    assert x.shape == (*ids[0].shape, sum(widths))
    np.testing.assert_array_equal(x.numpy(), want)  # a gather: exact
    for t, i, flat in zip(tt, ti, flats):  # the row ids: table_rows', clamped per lane
        rows_, want_flat = table_rows(t, i)
        assert flat.dtype == torch.int32 and torch.equal(flat, want_flat)
        n = t.shape[-2]
        lane = torch.arange(flat.numel()) // ids[0].shape[-1]
        lo = lane * n if t.dim() == 3 else torch.zeros_like(lane)
        assert bool(((flat >= lo) & (flat < lo + n)).all())
    x2, none = gather_fields_reference(tt, ti)
    assert torch.equal(x2, x) and none == (None,) * len(tt)


def test_gather_fields_marks_only_what_is_asked():
    tables, ids = _fields(3, (False, False, True))
    tt = [torch.from_numpy(t) for t in tables]
    ti = [torch.from_numpy(i) for i in ids]
    _, flats = gather_fields(tt, ti, train_mask=(False, False, True))
    assert flats[0] is None and flats[1] is None and flats[2].shape == (3 * 24,)
    with pytest.raises(ValueError, match="train_mask"):
        gather_fields(tt, ti, train_mask=(True,))
    assert torch.equal(embedding_lookup(tt[0], ti[0]), gather_fields(tt[:1], ti[:1])[0])


@pytest.mark.parametrize("lanes", [None, 3])
def test_gather_fields_gradient_matches_jax_grad(lanes):
    """d/dtable of sum(c * x) for the domain table (and the user table) against
    jax.grad through jnp.take(mode="clip"): clipped ids land on the edge rows."""
    stacked = (False, False, lanes is not None)
    tables, ids = _fields(lanes, stacked, seed=4)
    c = np.random.default_rng(5).normal(0, 1, (*ids[0].shape, 36)).astype(np.float32)

    def jloss(user, dom):
        x = jnp.concatenate([
            _jtake(user, ids[0]), _jtake(jnp.asarray(tables[1]), ids[1]), _jtake(dom, ids[2])],
            axis=-1)
        return jnp.sum(jnp.asarray(c) * x)

    gu, gd = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(tables[0]), jnp.asarray(tables[2]))
    tt = [torch.from_numpy(t).requires_grad_(k != 1) for k, t in enumerate(tables)]
    x, _ = gather_fields(tt, [torch.from_numpy(i) for i in ids])
    (x * torch.from_numpy(c)).sum().backward()
    assert tt[1].grad is None
    np.testing.assert_allclose(tt[0].grad.numpy(), np.asarray(gu), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tt[2].grad.numpy(), np.asarray(gd), rtol=1e-6, atol=1e-6)
    # the edge ids' gradient is on the edge rows: row 0 and row N-1 of each lane
    n = tables[2].shape[-2]
    edge = tt[2].grad.reshape(-1, n, 16)[:, [0, n - 1]]
    assert bool((edge != 0).all())


def _jtake(table, i):
    """jnp.take(mode="clip") of a table [N, D] or, lane by lane, [L, N, D]."""
    if table.ndim == 2:
        return jnp.take(table, jnp.asarray(i), axis=0, mode="clip")
    return jax.vmap(lambda t, j: jnp.take(t, j, axis=0, mode="clip"))(table, jnp.asarray(i))


@pytest.mark.parametrize("emb_trainable", [False, True])
def test_model_loss_gradient_matches_jax(emb_trainable):
    """The MLP's loss through make_loss_fn (EmbeddingBlock's one field gather)
    differentiated by autograd, against jax.grad of the JAX package's
    make_loss_fn on the same (converted) parameters, ids out of range
    included: every table the loss trains, within float32 summation order."""
    from mamdr_tpu.config import ExperimentConfig as JConfig
    from mamdr_tpu.models.zoo import build_model as jax_build_model
    from mamdr_tpu.train.steps import StepConfig as JStepConfig
    from mamdr_tpu.train.steps import make_loss_fn as jax_make_loss_fn
    from mamdr_tpu_torch.config import ExperimentConfig
    from mamdr_tpu_torch.convert import params_from_jax
    from mamdr_tpu_torch.models.zoo import build_model
    from mamdr_tpu_torch.train.steps import StepConfig, make_loss_fn
    from mamdr_tpu_torch.utils import trees

    d = {"model": {"name": "mlp", "user_dim": 8, "item_dim": 8, "domain_dim": 8,
                   "hidden_dim": [16, 8], "dropout": 0.0},
         "train": {"emb_trainable": emb_trainable}, "dataset": {"name": "synthetic"}}
    n_uid, n_pid, n_dom, b = 20, 30, 4, 32
    rng = np.random.default_rng(7)
    batch = {
        "uid": rng.integers(-3, n_uid + 3, b).astype(np.int32),
        "pid": rng.integers(0, n_pid, b).astype(np.int32),
        "domain": rng.integers(0, n_dom, b).astype(np.int32),
        "label": rng.integers(0, 2, b).astype(np.float32),
        "weight": np.ones(b, np.float32),
    }
    batch["domain"][:4] = [-1, n_dom, -(2**31), 2**31 - 1]
    jmodel = jax_build_model(JConfig.from_dict(d), n_uid, n_pid, n_dom)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jparams = jmodel.init({"params": jax.random.PRNGKey(0)}, jb["uid"], jb["pid"],
                          jb["domain"], train=False)["params"]
    jloss_fn = jax_make_loss_fn(jmodel, JStepConfig(emb_trainable=emb_trainable))
    jgrads = jax.grad(lambda p: jloss_fn({"model": p}, {}, jb, None, False)[0])(jparams)
    jnamed = dict(zip(jtrees.param_names(jgrads), jax.tree_util.tree_leaves(jgrads)))

    tmodel = build_model(ExperimentConfig.from_dict(d), n_uid, n_pid, n_dom)
    tparams = trees.tree_map(lambda t: t.requires_grad_(True),
                             params_from_jax(jax.device_get(jparams)))
    loss, _ = make_loss_fn(tmodel, StepConfig(emb_trainable=emb_trainable))(
        {"model": tparams}, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    for name, leaf in trees.leaves_with_names(tparams):
        if "emb" not in name:
            continue
        if not emb_trainable and ("user_emb" in name or "item_emb" in name):
            continue  # frozen: JAX stops their gradient, the port never asks for one
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jnamed[name]),
                                   rtol=1e-5, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("shapes,ids_shape,plan", [
    # the DN step: three 128-d fields of 1024 ids, 256 blocks of 4 warps
    (((100_000, 128), (100_000, 128), (30, 128)), (1024,),
     (1, 1024, 1024, (128, 128, 128), (0, 128, 256), (100_000, 100_000, 30), (0, 0, 0), 256)),
    # the DR lane-step: shared frozen tables, a lane-stacked domain table
    (((100_000, 128), (100_000, 128), (30, 30, 128)), (30, 1024),
     (30, 1024, 30720, (128, 128, 128), (0, 128, 256), (100_000, 100_000, 30), (0, 0, 30),
      7680)),
    # mixed widths, one id
    (((5, 16), (7, 24), (3, 32)), (1,), (1, 1, 1, (16, 24, 32), (0, 16, 40), (5, 7, 3),
                                         (0, 0, 0), 1)),
    (((9, 4),), (2, 37), (2, 37, 74, (4,), (0,), (9,), (0,), 19)),
])
def test_field_plan_lays_out_the_fields(shapes, ids_shape, plan):
    """Kernel K2's launch: fields in column order, a lane's stride in rows (0
    for a table every lane reads), one warp an output row."""
    got = field_plan(shapes, ids_shape)
    assert tuple(got)[:-1] == plan
    assert got.threads == 128 and got.blocks * 4 >= got.rows > (got.blocks - 1) * 4
    if got.rows >= 1024:
        assert got.blocks >= 132  # at least one wave of an H100's SMs


@pytest.mark.parametrize("shapes,ids_shape,match", [
    ((), (8,), "1 to 4 fields"),
    (((5, 4),) * 5, (8,), "1 to 4 fields"),
    (((5, 6),), (8,), "D % 4"),
    (((0, 8),), (8,), "empty"),
    (((3, 5, 8),), (8,), "lane-stacked"),   # a table a lane for one tower
    (((4, 5, 8),), (3, 8), "lane-stacked"),  # 4 tables for 3 lanes
    (((5, 8),), (2, 3, 8), r"\[B\] or \[L, B\]"),
    (((2**31, 4),), (8,), "int32"),
    (((2, 2**30, 4),), (2, 8), "int32"),
])
def test_field_plan_refuses_what_the_kernel_does_not_take(shapes, ids_shape, match):
    with pytest.raises(ValueError, match=match):
        field_plan(shapes, ids_shape)
