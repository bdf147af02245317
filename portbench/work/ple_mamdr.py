"""The work of MAMDR epochs on PLE, counted from shapes and from the epoch's
own draws.

A PLE example's operations are those its loss depends on: one CGC level of
its own domain (its ``t`` task experts and the ``s`` shared experts, each
3D -> h, the gate 3D -> t + s and the mix of t + s rows of h) and its
domain's tower (h -> units ... -> 1), forward, input gradient and weight
gradient each counted once: 6 * multiply-adds a row. The input gradient of
the first products is counted because the tables train. That is 8.49 MFLOP
a row at Amazon-13's widths (384 inputs, 5 + 2 experts of 512, tower 64),
whatever an implementation computes besides: the program computes every
domain's experts and tower for every row and keeps one logit, which this
count leaves out, so that a program that skips them reads as a gain.

``least_s["gemm"]`` is those operations at the float32-accurate rate of
the tensor cores that K1 uses, three TF32 products a product
(``GEMM_PASSES``), at the TF32 peak; the roofline of the model's products
reads the same work whatever kernels compute it.

The epoch's batches and Adam lane-steps come from a replay of its draws
(``work/mamdr_mlp.py``'s ``EpochWork``, the DR lanes in the program's
groups), each lane-step counting the rows that carry data.
"""

from __future__ import annotations

from typing import Dict, Sequence

from portbench.work.mamdr_mlp import EpochWork, plan_examples
from portbench.yardstick import PEAK_TF32_FLOPS, Work

GEMM_PASSES = 3  # TF32 products a float32-accurate product takes (K1's error compensation)


def gemm_kernel(name: str) -> bool:
    """A kernel of the model's products, by name: cuBLAS's and CUTLASS's
    matrix products carry ``gemm`` (any case), cuBLAS's matrix-vector ones
    ``gemv`` (the towers' one-unit logits), and a hand-written expert kernel
    the prefix ``ple_expert`` on its function's name."""
    low = name.lower()
    return "gemm" in low or "gemv" in low or "ple_expert" in name


def example_macs(d_in: int, expert: int, t: int, s: int, tower: Sequence[int]) -> int:
    """Multiply-adds of one row's forward pass that its loss depends on."""
    dims = (expert, *tower, 1)
    return ((t + s) * d_in * expert + d_in * (t + s) + (t + s) * expert
            + sum(a * b for a, b in zip(dims[:-1], dims[1:])))


def config_example_flops(cfg: Dict) -> int:
    """Forward and backward operations of one example (6 per multiply-add)."""
    return 6 * example_macs(3 * cfg["user_dim"], cfg["hidden_dim"][0],
                            cfg["specific_expert_num"], cfg["shared_expert_num"],
                            cfg["tower_hidden_dim"])


class PLEEpochWork(EpochWork):
    """``EpochWork``'s replay, a lane-step counting its batch, its Adam
    lane-steps and the least time of its rows' products."""

    def __init__(self, cfg: Dict, train, batch: int, device):
        super().__init__(cfg, train, batch, device)
        self.row_flops = config_example_flops(cfg)

    def _call(self, runs, s: int) -> Work:
        lane_rows = [max(0, min(self.batch, self.n_real[dom] - s * self.batch))
                     if s < pos.shape[0] else 0 for dom, pos in runs]
        n = sum(lane_rows)
        if not n:
            return Work()
        gemm = GEMM_PASSES * n * self.row_flops / PEAK_TF32_FLOPS
        return Work(batches=1, lane_steps=sum(1 for r in lane_rows if r),
                    least_s={"gemm": gemm})

    def _examples(self, order, aux) -> Work:
        ex = plan_examples(order, aux, self.n_real, self.batch,
                           self.cfg["domain_regulation_step"])
        n = ex["dn"] + ex["dr"]
        return Work(examples=n, flops=n * self.row_flops, phase_examples=ex)


class Counter:
    """Counts the work of epochs from the generators' states before each:
    the examples and their operations from the host draws alone, or
    (``full``) also every lane-step's batch, Adam lane-steps and least time
    of the products from a replay of all the draws."""

    def __init__(self, cfg: Dict, inputs, system, device):
        self.work = PLEEpochWork(cfg, inputs.traffic.splits["train"], cfg["batch_size"], device)
        self.group = system.group()

    def __call__(self, states, full: bool = False) -> Work:
        if full:
            return self.work.replay(*states, self.group)
        return self.work.examples(states[0])
