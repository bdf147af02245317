"""The readings the limits of ``correct`` are set from, on the card.

    python3 portbench/control.py --workload <cell> --seeds 11 12 ... \
        [--control-seeds 21 22 23] [--out control.jsonl]

For each of ``--seeds``: the program's first epochs at the cell's own size
(the set-up a run makes) against the reference's, the numbers of the
configuration's comparison (``checks/<check>.py``; the lower readings). For
each of ``--control-seeds`` also each of that comparison's ``CONTROLS``, the
reference with that control put in the program's place, against the
reference (the upper readings), and whether ``harness.judge`` fails each at
the cell's limits. One JSON line a reading, on standard output and in
``--out``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path[0] = ROOT

import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.card import card_line  # noqa: E402


def readings(cell, seed: int, device, controls: bool):
    """[(kind, numbers)] of one seed."""
    inp = harness.make_inputs(cell, seed, device)
    workdir = tempfile.mkdtemp(prefix="portbench-control-")
    t0 = time.perf_counter()
    system = harness.build_system(cell, inp, device, workdir)
    prog = harness.setup_epochs(system)
    t_prog = time.perf_counter() - t0
    system.close()
    del system
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    reference = harness.reference(cell, inp)
    ref = reference.run(harness.SETUP_EPOCHS)
    t_ref = time.perf_counter() - t0
    check = cell.parts.check
    out = [("program", check.compare(prog, ref, reference)[0],
            {"program_s": t_prog, "reference_s": t_ref})]
    if controls:
        for kind, kw in check.CONTROLS:
            other = harness.reference(cell, inp, **kw).run(harness.SETUP_EPOCHS)
            out.append((kind, check.compare(other, ref, reference)[0], {}))
    return out


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cell = harness.find_cell(args.workload)
    limits = harness.load_limits(harness.BENCH_DIR, cell.name, cell.parts.check.NUMBERS)
    print(f"control: card {card_line()}", file=sys.stderr)
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in list(args.seeds) + [s for s in args.control_seeds if s not in args.seeds]:
            for kind, numbers, extra in readings(cell, seed, device, seed in args.control_seeds):
                line = json.dumps({"workload": cell.name, "seed": seed, "kind": kind,
                                   "judged_correct": harness.judge(numbers, limits),
                                   **numbers, **extra})
                print(line, flush=True)
                if sink:
                    sink.write(line + "\n")
                    sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
