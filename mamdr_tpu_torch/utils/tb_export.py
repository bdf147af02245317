"""Export a metrics.jsonl event stream to TensorBoard scalar logs.

Counterpart of ``mamdr_tpu/utils/tb_export.py``: the trainer's live path
(``train.tensorboard`` / ``train.histogram_freq``) writes TensorBoard as it
trains; this converts the ``metrics.jsonl`` of a past run (of either package:
the two write the same events) so its curves can be viewed after the fact.
Every ``{mode}_eval`` event gives ``{mode}/avg_loss``, ``{mode}/avg_auc`` and
``{mode}/domain_{k}_AUC`` at step ``epoch``, with the event's ``ts`` as the
wall time, written through ``torch.utils.tensorboard.SummaryWriter``.

Usage:
    python -m mamdr_tpu_torch.utils.tb_export <metrics.jsonl> [--out LOGDIR]

Default LOGDIR is ``tensorboard/`` next to the metrics file.
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
from typing import Optional


def export(metrics_path: str, out_dir: Optional[str] = None) -> str:
    """Write the scalars of ``metrics_path`` under ``out_dir``; returns it."""
    from torch.utils.tensorboard import SummaryWriter

    out_dir = out_dir or osp.join(osp.dirname(osp.abspath(metrics_path)), "tensorboard")
    writer = SummaryWriter(log_dir=out_dir)
    n = 0
    with open(metrics_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            event = rec.get("event", "")
            if not event.endswith("_eval"):
                continue
            mode = event[: -len("_eval")]
            step = int(rec.get("epoch") or 0)
            values = [(key, rec[key]) for key in ("avg_loss", "avg_auc") if key in rec]
            values += [(f"domain_{k}_AUC", v) for k, v in (rec.get("domain_auc") or {}).items()]
            for name, v in values:
                writer.add_scalar(f"{mode}/{name}", float(v), step, walltime=rec.get("ts"))
            n += len(values)
    writer.close()
    print(f"wrote {n} scalars -> {out_dir}")
    return out_dir


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("metrics", help="path to a metrics.jsonl file")
    p.add_argument("--out", default=None, help="TensorBoard logdir")
    args = p.parse_args()
    export(args.metrics, args.out)


if __name__ == "__main__":
    main()
