"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test decides inside a fixture whether a card is present
and skips without one. This file imports no JAX, so it runs on a machine
that has only PyTorch (the repo's conftest imports JAX; skip it there):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py

Matmuls of the plain versions run in full float32 (TF32 off).
"""

import numpy as np
import pytest
import torch

from mamdr_tpu_torch.ops.embedding_lookup import (
    embedding_lookup,
    embedding_lookup_reference,
)
from mamdr_tpu_torch.ops.fused_mlp_step import fused_tower_grad, tower_grad_reference

K1_REL_TOL = 1e-4  # of each output's largest magnitude: float32 sums over
                   # up to 1024 rows, taken in another order


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tower_inputs(dims, batch, case, device, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    x = rng.normal(0, 0.1, (batch, dims[0])).astype(np.float32)
    label = rng.integers(0, 2, batch).astype(np.float32)
    weight = (rng.uniform(0, 1, batch) > 0.2).astype(np.float32)
    if case == "partial":
        weight[:] = 1.0
        weight[batch * 2 // 3 :] = 0.0
    elif case == "all_pad":
        weight[:] = 0.0
    dense = []
    for i in range(len(dims) - 1):
        lim = np.sqrt(6.0 / (dims[i] + dims[i + 1]))
        dense.append(rng.uniform(-lim, lim, (dims[i], dims[i + 1])).astype(np.float32))
        dense.append(rng.normal(0, 0.05, dims[i + 1]).astype(np.float32))
    dense.append(rng.normal(0, 0.2, (dims[-1], 1)).astype(np.float32))
    seeds = torch.tensor([0xDEADBEEF, 7, 2**31 + 5][: len(dims) - 1], dtype=torch.int64,
                         device=device)
    return t(x), t(label), t(weight), seeds, tuple(t(a) for a in dense)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("case", ["mixed", "partial", "all_pad"])
@pytest.mark.parametrize("dims,batch", [((384, 256, 128, 64), 1024), ((24, 32, 16), 37)])
def test_tower_kernel_matches_plain(cuda_device, rate, case, dims, batch):
    """K1 at the main path's shapes, and at a small ragged shape whose edges
    cut through every tile."""
    args = _tower_inputs(dims, batch, case, cuda_device)
    before = fused_tower_grad.launches
    lk, dxk, gk = fused_tower_grad(*args, dims, rate)
    assert fused_tower_grad.launches == before + 1
    lp, dxp, gp = tower_grad_reference(*args, dims, rate)
    torch.cuda.synchronize()
    assert len(gk) == len(gp) == 2 * (len(dims) - 1) + 1
    for a, b in [(lk, lp), (dxk, dxp), *zip(gk, gp)]:
        assert a.shape == b.shape
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= K1_REL_TOL * scale
    # no atomics: a second call gives the same bits
    lk2, dxk2, gk2 = fused_tower_grad(*args, dims, rate)
    for a, b in [(lk, lk2), (dxk, dxk2), *zip(gk, gk2)]:
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_gather_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(0)
    n, d, b = 100_000, 128, 1024
    table = torch.from_numpy(rng.normal(0, 1, (n, d)).astype(np.float32)).to(cuda_device)
    ids_np = rng.integers(0, n, b).astype(np.int32)
    ids_np[:4] = [-1, n, -(2**31), 2**31 - 1]
    ids = torch.from_numpy(ids_np).to(cuda_device)
    before = embedding_lookup.launches
    got = embedding_lookup(table, ids)
    torch.cuda.synchronize()
    assert embedding_lookup.launches == before + 1
    assert torch.equal(got, embedding_lookup_reference(table, ids))  # a gather: exact
    with pytest.raises(ValueError):
        embedding_lookup(table, ids.long())  # the kernel takes int32 ids only
    with pytest.raises(ValueError):
        embedding_lookup(table[:, :6].contiguous(), ids)  # D % 4 != 0
