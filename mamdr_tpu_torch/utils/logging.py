"""Structured metrics: an append-only JSONL event log.

Counterpart of ``MetricsLogger`` in ``mamdr_tpu/utils/logging.py`` (:19-42):
one JSON object a line, ``{"ts", "event", ...}``; ``Trainer.summarize``
writes a ``{mode}_eval`` event per evaluation. TensorBoard export and the
profiler hook are not ported.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import time
from typing import Dict, Optional


class MetricsLogger:
    """Append-only JSONL event log; a no-op when ``path`` is falsy. The
    directory is made at the first event."""

    def __init__(self, path: Optional[str]):
        self.path = path

    def log(self, event: str, **fields) -> None:
        if not self.path:
            return
        os.makedirs(osp.dirname(osp.abspath(self.path)), exist_ok=True)
        rec = {"ts": round(time.time(), 3), "event": event}
        rec.update(fields)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def log_eval(self, mode: str, epoch, avg_loss, avg_auc, domain_auc: Dict) -> None:
        self.log(
            f"{mode}_eval",
            epoch=epoch,
            avg_loss=float(avg_loss),
            avg_auc=float(avg_auc),
            domain_auc={k: float(v) for k, v in domain_auc.items()},
        )
