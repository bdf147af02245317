"""Structured metrics: an append-only JSONL event log, and TensorBoard.

Counterpart of ``MetricsLogger`` and ``TensorBoardLogger`` in
``mamdr_tpu/utils/logging.py`` (:19-145): one JSON object a line,
``{"ts", "event", ...}``, ``Trainer.summarize`` writing a ``{mode}_eval``
event per evaluation; and the per-evaluation TensorBoard scalars with the
weight and gradient histograms of the reference's Keras TensorBoard
callback (reference model_zoo/maml.py:42-45), written, as the JAX package
writes them, through ``torch.utils.tensorboard.SummaryWriter`` (imported at
the first write, so a run without TensorBoard never imports it). A
histogram's buckets are counted on the tensor's device (``histogram``) and
handed to ``add_histogram_raw``. On a (data, table) mesh every rank calls
the logger alike and only rank 0 opens a writer: a leaf split over the
table group is counted on each shard and the counts and sums are added
over the group (``histogram(..., mesh=)``), so no table is gathered for its
histogram. The profiler hook (the JAX package's ``maybe_profile``) is
``utils/trace.py``'s ``profiled``, which ``train.profile_dir`` turns on.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from mamdr_tpu_torch.parallel.mesh import TABLE_AXIS, all_gather_dim0, all_reduce_sum
from mamdr_tpu_torch.utils import trace, trees


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


def _default_bins() -> List[float]:
    """SummaryWriter's ``default_bins``: -1e20 .. -1e-12, 0, 1e-12 .. 1e20,
    each limit 1.1 times the one before (in double precision)."""
    v, pos, neg = 1e-12, [], []
    while v < 1e20:
        pos.append(v)
        neg.append(-v)
        v *= 1.1
    return neg[::-1] + [0.0] + pos


DEFAULT_BINS = _default_bins()


def histogram(values: torch.Tensor, mesh=None) -> Dict:
    """The histogram ``SummaryWriter.add_histogram(bins="tensorflow")``
    writes for ``values``, as ``add_histogram_raw``'s arguments. The values
    are taken in float64; the buckets are counted on the tensor's device
    with ``np.histogram``'s rule (each bucket [lo, hi), the last [lo, hi]),
    and trimmed as ``make_histogram`` trims them. One host read.

    With ``mesh``, ``values`` is this rank's part of a leaf split over the
    table group, and the result is the whole leaf's on every member: the
    buckets, ``num``, ``sum`` and ``sum_squares`` added over the group in
    one ``all_reduce``, ``min`` and ``max`` taken over one exact all-gather.
    Every member must call it."""
    x = values.detach().reshape(-1).to(torch.float64)
    if x.numel() == 0:
        raise ValueError("histogram of no values")
    edges = torch.tensor(DEFAULT_BINS, dtype=torch.float64, device=x.device)
    n_bins = edges.numel() - 1
    idx = torch.searchsorted(edges, x, right=True) - 1
    idx = torch.where(x == edges[-1], n_bins - 1, idx)
    inside = (idx >= 0) & (idx < n_bins)
    counts = torch.bincount(idx[inside], minlength=n_bins)
    num = x.numel()
    if mesh is None:
        stats = trace.to_host(torch.stack([x.min(), x.max(), x.sum(), torch.dot(x, x)]))
        counts = trace.to_host(counts)
    else:
        summed = trace.to_host(all_reduce_sum(mesh, torch.cat([
            counts.to(torch.float64),
            torch.stack([x.sum(), torch.dot(x, x), x.new_tensor(float(num))])]), TABLE_AXIS))
        ends = trace.to_host(all_gather_dim0(
            mesh, torch.stack([x.min(), -x.max()]).reshape(1, 2), TABLE_AXIS).amin(dim=0))
        counts = summed[:n_bins].astype(np.int64)
        stats = np.asarray([ends[0], -ends[1], summed[n_bins], summed[n_bins + 1]])
        num = int(summed[n_bins + 2])
    limits = np.asarray(DEFAULT_BINS)

    cum = np.cumsum(np.greater(counts, 0))
    start, end = np.searchsorted(cum, [0, cum[-1] - 1], side="right")
    start, end = int(start), int(end) + 1
    counts = counts[start - 1:end] if start > 0 else np.concatenate([[0], counts[:end]])
    limits = limits[start:end + 1]
    return {"min": float(stats[0]), "max": float(stats[1]), "num": int(num),
            "sum": float(stats[2]), "sum_squares": float(stats[3]),
            "bucket_limits": [float(v) for v in limits],
            "bucket_counts": [float(c) for c in counts]}


class TensorBoardLogger:
    """Per-evaluation TensorBoard scalars and weight / gradient histograms,
    with the JAX package's enable rules: ``histogram_freq > 0`` turns the
    writer on as ``enabled`` does; histograms are written every
    ``histogram_freq`` val epochs; ``write_grads`` counts only when
    ``histogram_freq > 0``. A disabled logger writes nothing and makes no
    directory; an enabled one opens its ``SummaryWriter`` at ``logdir`` at
    its first write. ``mesh``: every rank of the mesh holds a logger with
    the same settings and makes the same calls; rank 0 alone writes (the
    others open no writer and make no directory)."""

    def __init__(self, logdir: Optional[str], histogram_freq: int = 0,
                 enabled: bool = False, write_grads: bool = False, mesh=None):
        self.histogram_freq = int(histogram_freq)
        self.enabled = bool(enabled) or self.histogram_freq > 0
        self.write_grads = bool(write_grads) and self.histogram_freq > 0
        self.logdir = logdir
        self.mesh = mesh
        self.writes = mesh is None or mesh.rank == 0
        self._writer = None
        if self.enabled and not logdir:
            raise ValueError("TensorBoardLogger enabled without a logdir")

    @property
    def writer(self):
        if self._writer is None:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(log_dir=self.logdir)
        return self._writer

    def histograms_due(self, epoch: int) -> bool:
        return self.histogram_freq > 0 and epoch % self.histogram_freq == 0

    def log_eval(self, mode: str, epoch: int, avg_loss, avg_auc,
                 domain_auc: Dict, weighted_auc=None) -> None:
        """``{mode}/avg_loss``, ``{mode}/avg_auc``, ``{mode}/weighted_auc``
        (when given) and ``{mode}/domain_{k}_AUC`` at step ``epoch``."""
        if not (self.enabled and self.writes):
            return
        w = self.writer
        w.add_scalar(f"{mode}/avg_loss", float(avg_loss), epoch)
        w.add_scalar(f"{mode}/avg_auc", float(avg_auc), epoch)
        if weighted_auc is not None:
            w.add_scalar(f"{mode}/weighted_auc", float(weighted_auc), epoch)
        for k, v in domain_auc.items():
            w.add_scalar(f"{mode}/domain_{k}_AUC", float(v), epoch)
        w.flush()

    def _histograms(self, epoch: int, tree, prefix: str, axes=None) -> None:
        split = (dict(trees.leaves_with_names(axes)) if axes is not None and self.mesh
                 is not None else {})
        for name, leaf in trees.leaves_with_names(tree):
            h = histogram(leaf, self.mesh if split.get(name) else None)
            if self.writes:
                self.writer.add_histogram_raw(prefix + name, global_step=epoch, **h)
        if self.writes:
            self.writer.flush()

    def log_histograms(self, epoch: int, params, axes=None) -> None:
        """A histogram of every leaf of ``params``, tagged with its path,
        every ``histogram_freq`` val epochs (Keras TensorBoard semantics).
        On a mesh, ``axes`` (a tree like ``params``) marks the leaves split
        over the table group: each is the whole leaf's histogram."""
        if self.histograms_due(epoch):
            self._histograms(epoch, params, "", axes)

    def log_grad_histograms(self, epoch: int, grads, axes=None) -> None:
        """``grad/<path>`` histograms of a gradient tree (the loss gradient
        on a sample batch; the reference's ``write_grads=True``), on the
        same epochs as ``log_histograms``; ``axes`` as there."""
        if self.write_grads and self.histograms_due(epoch):
            self._histograms(epoch, grads, "grad/", axes)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
