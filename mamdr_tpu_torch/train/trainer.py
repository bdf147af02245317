"""Trainer: model, optimizers, state, device-resident data and evaluation.

Counterpart of ``mamdr_tpu/train/trainer.py`` for one device: construction
(with the uncertainty-weighted model's ``log_vars`` and the meta
accumulators' ``accum_grad_fn``), ``train_block`` / ``steps_per_domain``,
the per-domain evaluation with macro and example-weighted AUC (reference
base_model.py:111-175) as one lane-batched eval over all domains, the
strict-improvement early stop (base_model.py:202-224), the best-params
checkpoint, the resume snapshot (``save_resume_state`` / ``try_resume``,
trainer.py:480-502), the JSONL metrics, TensorBoard (``self.tb`` at
``<checkpoint_dir>/tensorboard``: every evaluation's scalars, and on a val
evaluation the weight histograms and the gradient histograms of
``_sample_grads``, trainer.py:198-206, 440-455) and the run's result folder
(``save_result``).

The per-call route (trainer.py:330-405), which every strategy's loop takes
where its fused pass does not (``fused_padding_ok`` false: a fixed train
order, or a train block past the memory budget): ``stack_train_epoch``
forms one domain-epoch's [S, B] batches, ``fit_domain`` trains them
(``finetune``: with the finetune optimizer), ``eval_stack`` /
``evaluate_domain`` score one domain. The batches are the JAX package's
``stack_batches`` bit for bit, pad rows included: the order is one
``np_rng.permutation`` (natural under ``fixed_train``), made on the host
and uploaded alone — through pinned memory without waiting — and the rows
are gathered on the device from each split's columns, which are uploaded
once (or, past half the block budget, gathered on the host and staged
through pinned memory).

On a (data, table) mesh (``mesh=``, parallel/mesh.py; one process a rank,
JAX trainer.py:60-151): the user and item tables are padded to the table
axis (``pad_rows``, pretrained ones included), each rank keeps its rows of
those the mesh lookup shards (``sharded_lookup_min_rows``) and, with
``shard_experts``, its experts of the MMoE / PLE banks (``shard_axes``),
with Adam's slots following them, and the steps and evals read the fields through
``StepConfig.lookup`` (``MeshLookup``): one-tower train and accumulate
steps split a batch's rows over the data group, the all-domain evals split
the domains over it, a per-call ``evaluate_domain`` runs its domain whole on
every rank. The host's draws agree on every rank (one seed); the
checkpoint folder's timestamp is rank 0's. Files are written once, by rank
0, with the whole tables gathered over the table group at their padded
row count (what the JAX package writes), while the other ranks wait; the
metrics log is rank 0's, and only rank 0 prints. The resume snapshot is
written the same way (flat Adam's slots in the whole tree's order) and read
on every rank, each keeping its rows; TensorBoard's writer is rank 0's, and
every rank counts its shards of the histograms (``TensorBoardLogger``).

Randomness is explicit: ``np_rng`` (numpy, seeded by the dataset seed) makes
the host-side draws the JAX package makes with numpy — domain order, aux
domains, support/query splits, the per-call route's batch orders — so both
packages draw the same values; a CPU ``torch.Generator`` seeds parameter
init, the base dropout seeds and the "drop" meta gradients' mask seeds
(``draw_seed``); ``gen``, a generator on the run's device, makes the fused
passes' batch shuffles.

``epochs`` numbers a strategy's train epochs and makes each one, with its
validation and snapshots, the span ``trainer.epoch`` through ``profiled``,
as the separate and finetune runs make theirs (``trainer.finetune`` in the
finetune stage); with ``train.profile_dir`` each runs under the profiler
with the program's spans on (utils/trace.py), writes
``<profile_dir>/<name>.trace.json`` and logs its counters as an
``epoch_counters`` event.
"""

from __future__ import annotations

import contextlib
import json
import os
import os.path as osp
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from mamdr_tpu_torch import DeviceLike, resolve_device
from mamdr_tpu_torch.config import ExperimentConfig
from mamdr_tpu_torch.data.dataset import COLUMNS, DomainSplit, MultiDomainDataset, batch_rows
from mamdr_tpu_torch.models.embeddings import frozen_mask
from mamdr_tpu_torch.models.zoo import build_model
from mamdr_tpu_torch.parallel.data_feed import data_rows
from mamdr_tpu_torch.parallel.embedding_shard import MeshLookup, pad_rows
from mamdr_tpu_torch.parallel.mesh import DATA_AXIS, all_reduce_sum_, barrier, broadcast_object
from mamdr_tpu_torch.parallel.trainer_sharding import (
    shard_flat_slots,
    shard_train_state,
    shard_tree,
    sharded_axes,
    whole_flat_slots,
    whole_train_state,
    whole_tree,
)
from mamdr_tpu_torch.train import checkpoints, fused
from mamdr_tpu_torch.train.state import TrainState
from mamdr_tpu_torch.train.steps import (
    StepConfig,
    make_accum_grad_fn,
    make_eval_epoch,
    make_loss_fn,
    make_optimizer,
    make_train_epoch,
    make_train_step,
)
from mamdr_tpu_torch.utils import trace, trees
from mamdr_tpu_torch.utils.logging import MetricsLogger, TensorBoardLogger

# The JAX package's gate for its fused paths (trainer.py:227-264): a padded
# lane pays when padding at most quadruples the steps or wastes under 250
# steps a domain; a ragged path's [D, N_pad] block must stay under 4 GiB.
MAX_WASTE_RATIO = 4.0
STEPS_PER_DISPATCH = 250.0
MAX_BLOCK_BYTES = 4 * 2**30


def _pad_table(table, n: int):
    """A pretrained table with zero rows appended up to ``n`` (None stays)."""
    if table is None or table.shape[0] == n:
        return table
    out = np.zeros((n, table.shape[1]), table.dtype)
    out[: table.shape[0]] = table
    return out


class EarlyStopper:
    """Strict-improvement early stop (reference base_model.py:202-224)."""

    def __init__(self, patience: int):
        self.patience = patience
        self.counter = 0
        self.best_metric: Optional[float] = None
        self.early_stop = False
        self.improved = False

    def step(self, metric: float) -> bool:
        """True when training should stop; ``improved`` says whether to save."""
        self.improved = False
        if self.best_metric is None or metric > self.best_metric:
            self.best_metric = metric
            self.counter = 0
            self.improved = True
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.early_stop = True
        return self.early_stop


class Trainer:
    def __init__(self, config: ExperimentConfig, dataset: MultiDomainDataset,
                 device: DeviceLike = None, verbose: bool = True, mesh=None):
        """device: None runs on the CUDA card (and raises without one);
        "cpu" runs the plain versions of the kernels on the CPU. verbose:
        print each evaluation's table, as the JAX package does. mesh: this
        rank's ``parallel.mesh.Mesh``; the trainer then runs on its device
        (see the module docstring)."""
        self.mesh = mesh
        if mesh is not None:
            device = mesh.device if device is None else device
            if torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh rank's {mesh.device}")
        self.device = resolve_device(device)
        self.config = config
        self.dataset = dataset
        tc, mc = config.train, config.model
        self.rank0 = mesh is None or mesh.rank == 0
        self.verbose = verbose and self.rank0
        self._n_uid, self._n_pid = dataset.n_uid, dataset.n_pid
        self._pretrained = (dataset.user_emb, dataset.item_emb)
        if mesh is not None:
            self._n_uid, self._n_pid = pad_rows(self._n_uid, mesh.table), pad_rows(
                self._n_pid, mesh.table)
            self._pretrained = tuple(_pad_table(t, n) for t, n in zip(
                self._pretrained, (self._n_uid, self._n_pid)))
            self._sample_batch()  # refuses a domain 0 smaller than the data axis, as JAX's init
        self.np_rng = np.random.default_rng(dataset.seed)
        init_gen = torch.Generator().manual_seed(dataset.seed)
        self.model = self._build_model(init_gen)
        whole = self.model.param_tree()
        # on a mesh: the axis (from the end) of each leaf this rank keeps a
        # slice of — the sharded tables' rows, with shard_experts the expert
        # banks' leading axis — else None
        self.shard_axes = {"model": trees.tree_map(lambda x: None, whole) if mesh is None
                           else sharded_axes(whole, mesh, tc.sharded_lookup_min_rows,
                                             tc.shard_experts)}
        params = {"model": trees.tree_map(lambda p: p.to(self.device, copy=True),
                                          self._shard(whole, self.shard_axes["model"]))}
        params.update(self._uncertainty_params(self.device))
        self.shard_axes.update(trees.tree_map(lambda x: None, {
            k: v for k, v in params.items() if k != "model"}))
        dropout_seed = int(torch.randint(0, 2**32, (), generator=init_gen,
                                         dtype=torch.int64))
        self._seed_gen = init_gen  # later base seeds (draw_seed)
        self.gen = torch.Generator(device=self.device).manual_seed(dataset.seed)

        lookup = None
        if mesh is not None:
            emb = self.shard_axes["model"].get("embedding", {})
            lookup = MeshLookup(mesh, (bool(emb.get("user_emb")), bool(emb.get("item_emb")),
                                       False))
        self.step_cfg = StepConfig(uncertainty_weight=config.spec.uncertainty_weight,
                                   l2_emb=1e-5, emb_trainable=tc.emb_trainable, lookup=lookup)
        self.tx = make_optimizer(tc.optimizer, tc.learning_rate, params,
                                 tc.emb_trainable, flat=tc.flat_optimizer)
        # a model with a norm starts from its initial moving statistics (STAR)
        stats = trees.tree_map(lambda x: x.to(self.device), self.model.init_stats())
        self.state = TrainState.create(params, self.tx.init(params), dropout_seed,
                                       self.device, batch_stats=stats)
        self._train_block: Optional[Tuple[Dict[str, torch.Tensor], int]] = None

        # The finetune stage's optimizer: SGD at lr 1e-3 in the reference
        # (base_model.py:69, specific_base_model.py:120). Adam here is the
        # flat form, which the JAX package holds bit-exact to optax.adam.
        self.finetune_tx = make_optimizer(tc.finetune_optimizer, tc.finetune_learning_rate,
                                          params, tc.emb_trainable)
        self.loss_fn = make_loss_fn(self.model, self.step_cfg)
        # grads at fixed params for the meta accumulators (K1 at rate 0 where
        # the gate allows, autograd otherwise)
        self.accum_grad_fn = make_accum_grad_fn(self.model, self.step_cfg)
        self._eval_blocks: Dict[str, Dict[str, torch.Tensor]] = {}
        self._eval_fn: Optional[Callable] = None
        # the per-call route: each split's packed columns on the device (kept
        # with the split, so its id stays its own), the [S, B] eval batches,
        # the epoch functions
        self._rows: Dict[int, Tuple[DomainSplit, torch.Tensor]] = {}
        self._rows_on_device = (16 * sum(s.n for s in dataset.train)
                                <= MAX_BLOCK_BYTES // 2)
        self._eval_stacks: Dict[Tuple[str, int], Dict[str, torch.Tensor]] = {}
        self._epoch_fns: Dict[bool, Callable] = {}
        self._eval_epoch: Optional[Callable] = None
        self.stopper = EarlyStopper(tc.patience)
        self.best_params = None  # on-device copy of the best checkpoint

        ts = time.strftime("%Y%m%d-%H%M%S")
        if mesh is not None:
            ts = broadcast_object(ts)
        ds_cfg = config.dataset
        self.checkpoint_dir = osp.join(tc.checkpoint_path, mc.name, ds_cfg.name,
                                       ds_cfg.domain_split_path, ts)
        self.checkpoint_path = osp.join(self.checkpoint_dir, "model_parameters.npz")
        # timestamp-free, so a restarted process finds it
        self.resume_dir = osp.join(tc.checkpoint_path, mc.name, ds_cfg.name,
                                   ds_cfg.domain_split_path, "resume")
        self.result_dir = osp.join(tc.result_save_path, mc.name, ds_cfg.name,
                                   ds_cfg.domain_split_path)
        self.metrics = MetricsLogger(
            osp.join(self.checkpoint_dir, "metrics.jsonl")
            if tc.metrics_jsonl and self.rank0 else None)
        # the reference's Keras TensorBoard callback at dirname(checkpoint_path)
        # (maml.py:21-23); histogram_freq > 0 turns the writer on
        self.tb = TensorBoardLogger(osp.join(self.checkpoint_dir, "tensorboard"),
                                    histogram_freq=tc.histogram_freq, enabled=tc.tensorboard,
                                    write_grads=tc.write_grads, mesh=mesh)
        self._eval_epoch_counter = 0

    def _build_model(self, generator: torch.Generator):
        """The config's base model, its init drawn from ``generator`` (on a
        mesh: the padded tables, whole; with ``shard_experts`` the mesh its
        expert slices run on)."""
        ds = self.dataset
        experts = self.mesh if self.config.train.shard_experts else None
        return build_model(self.config, n_uid=self._n_uid, n_pid=self._n_pid,
                           n_domain=ds.n_domain, pretrained_user=self._pretrained[0],
                           pretrained_item=self._pretrained[1], generator=generator,
                           expert_mesh=experts)

    def _shard(self, tree, axes):
        """This rank's part of a whole tree (its slice of each leaf ``axes``
        splits); the tree itself without a mesh."""
        if self.mesh is None:
            return tree
        return shard_tree(tree, axes, self.mesh)

    def whole(self, tree, axes=None):
        """A params-shaped tree with each split leaf gathered whole over the
        table group (every rank of the group must call it); the tree itself
        without a mesh. ``axes`` defaults to ``shard_axes`` (a leaf may carry
        a leading lane or domain axis)."""
        if self.mesh is None:
            return tree
        return whole_tree(tree, self.shard_axes if axes is None else axes, self.mesh)

    def save_tree(self, path: str, tree, keep=None, axes=None) -> None:
        """``checkpoints.save_pytree`` of the whole tree (``whole``), written
        by rank 0 while the other ranks wait."""
        tree = self.whole(tree, axes)
        if self.rank0:
            checkpoints.save_pytree(path, tree, keep=keep)
        self._barrier()

    def save_decomposition(self, dirpath: str, shared, specific, extra, mask) -> None:
        """``checkpoints.save_decomposition`` of whole trees, by rank 0: the
        shared tree whole, and of each specific tree the masked leaves (the
        ones its file keeps)."""
        spec_axes = trees.tree_map(lambda a, m: a if m else None, self.shard_axes, mask)
        with trace.span("trainer.snapshot"):
            shared = self.whole(shared)
            specific = [self.whole(s, spec_axes) for s in specific]
            if self.rank0:
                checkpoints.save_decomposition(dirpath, shared, specific, extra=extra,
                                               mask=mask)
            self._barrier()

    def _barrier(self) -> None:
        if self.mesh is not None:
            barrier()

    def fresh_params(self, seed: int):
        """A fresh random draw of the full parameter tree, on the CPU
        (pretrained tables are the dataset's buffers, not copies; on a mesh,
        this rank's rows of the sharded tables). MAMDR's per-domain
        specific init re-runs the initialisers per domain (reference
        mamdr.py:30-33)."""
        model = self._build_model(torch.Generator().manual_seed(seed))
        return {"model": self._shard(model.param_tree(), self.shard_axes["model"]),
                **self._uncertainty_params("cpu")}

    def _uncertainty_params(self, device):
        """{'uncertainty': {'log_vars': ones [n_domain, 1]}} when the model name
        asks for uncertainty weighting (the WeightedLoss init of
        weighted_loss.py:15-27), else {}. The model's optimizer trains it."""
        if not self.config.spec.uncertainty_weight:
            return {}
        return {"uncertainty": {"log_vars": torch.ones(
            (self.dataset.n_domain, 1), dtype=torch.float32, device=device)}}

    def train_block(self):
        """Device-resident ({col: [D, N_pad]}, n_steps) train block."""
        if self._train_block is None:
            self._train_block = fused.stack_domains_on_device(
                self.dataset.train, self.dataset.batch_size, self.device)
        return self._train_block

    def steps_per_domain(self) -> List[int]:
        """Per-domain real step counts ceil(n_d / B)."""
        return fused.domain_step_counts(self.dataset.train, self.dataset.batch_size)

    def train_step_fn(self):
        """The model's train step; its loss gradient is ``steps.make_loss_grad``'s
        choice (K1 for the plain MLP, autograd for the other base models and
        under uncertainty weighting)."""
        return make_train_step(self.model, self.tx, self.step_cfg)

    def frozen_mask(self):
        """``models/embeddings.frozen_mask`` of the state's params."""
        return frozen_mask(self.state.params, self.config.train.emb_trainable)

    def draw_seed(self) -> int:
        """A fresh uint32 base dropout seed from the trainer's CPU generator
        (the finetune lanes' base, fast_random.lane_seeds)."""
        return int(torch.randint(0, 2**32, (), generator=self._seed_gen, dtype=torch.int64))

    def fused_padding_ok(self, ragged: bool = False) -> bool:
        """The JAX package's gate for its fused paths (trainer.py:227-264),
        which pad every domain to the largest one's step count: padded
        lanes pay when the waste ratio is small or the wasted steps stay
        under the break-even; ``ragged`` paths (only real steps run) pay in
        memory only, so the [D, N_pad] block must stay under
        ``MAX_BLOCK_BYTES``. A dataset with ``fixed_train`` set (its own
        attribute, as the JAX package reads it) gets False, ragged too: the
        fused passes shuffle, and the per-call loops keep the order. The
        port takes the same routes on the same data."""
        if getattr(self.dataset, "fixed_train", False):
            return False
        steps = self.steps_per_domain()
        d = len(steps)
        total_padded = max(steps) * d
        if ragged:
            block_bytes = total_padded * self.dataset.batch_size * 5 * 4
            return block_bytes <= MAX_BLOCK_BYTES
        if total_padded <= MAX_WASTE_RATIO * sum(steps):
            return True
        return (total_padded - sum(steps)) <= STEPS_PER_DISPATCH * d

    # ---------------- the per-call route ----------------

    def _packed_rows(self, split: DomainSplit) -> np.ndarray:
        """The split's columns as one [n, 4] int32 array (the float label
        reinterpreted, a bit-exact round trip), in ``COLUMNS`` order."""
        return np.stack([getattr(split, k).view(np.int32) for k in COLUMNS], axis=1)

    def _upload(self, host: np.ndarray) -> torch.Tensor:
        """A host array on the run's device: through pinned memory without
        waiting for the card (the caching host allocator keeps the buffer
        until the copy has run), or as it is on the CPU."""
        t = torch.from_numpy(np.ascontiguousarray(host))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def stack_split(self, split: DomainSplit, shuffle: bool,
                    max_steps: int = 0) -> Dict[str, torch.Tensor]:
        """One epoch of ``split`` as {col: [S, B]} on the device (JAX
        ``stack_batches`` then the ``max_steps`` cut, trainer.py:330-343), bit
        for bit: the order from ``np_rng`` (one permutation draw) when
        ``shuffle``, wrap-around pad rows with weight 0, at most ``max_steps``
        batches when that is positive. Only the order crosses to the device
        (``_upload``); the rows are gathered there from the split's columns,
        uploaded once per split. Past half the block budget the rows are
        gathered on the host and staged instead."""
        b = self.dataset.batch_size
        idx = batch_rows(split.n, b, shuffle, self.np_rng)
        if max_steps and max_steps > 0:
            idx = idx[: max_steps * b]
        if self._rows_on_device:
            entry = self._rows.get(id(split))
            if entry is None or entry[0] is not split:
                entry = self._rows[id(split)] = (
                    split, torch.from_numpy(self._packed_rows(split)).to(self.device))
            packed = entry[1].index_select(0, self._upload(idx.astype(np.int64)))
        else:
            packed = self._upload(self._packed_rows(split)[idx])
        cols = packed.t().reshape(len(COLUMNS), -1, b).contiguous()  # [4, S, B]
        out = {k: cols[j] for j, k in enumerate(COLUMNS)}
        out["label"] = out["label"].view(torch.float32)
        pos = torch.arange(idx.shape[0], device=self.device).reshape(-1, b)
        out["weight"] = (pos < split.n).to(torch.float32)
        return out

    def stack_train_epoch(self, domain_idx: int, split: Optional[DomainSplit] = None,
                          max_steps: int = 0) -> Dict[str, torch.Tensor]:
        """One domain-epoch of train batches (default: the domain's train
        split), shuffled unless the dataset has ``fixed_train``, at most
        ``max_steps`` of them (meta_train_step / domain_regulation_step)."""
        split = split if split is not None else self.dataset.train[domain_idx]
        return self.stack_split(split, shuffle=not getattr(self.dataset, "fixed_train", False),
                                max_steps=max_steps)

    def fit_domain(self, state: TrainState, domain_idx: int,
                   split: Optional[DomainSplit] = None, max_steps: int = 0,
                   finetune: bool = False) -> Tuple[TrainState, torch.Tensor]:
        """One epoch over one domain (``stack_train_epoch``), chained from
        ``state`` (JAX ``fit_domain``, trainer.py:384-395): the model's
        train step (K1 and K2 a step for the plain MLP, autograd and K2
        otherwise) with its optimizer, or with the finetune optimizer when
        ``finetune``. Returns (state, the mean data loss as a 0-d tensor on
        the device: float() it only where it is printed)."""
        stacked = self.stack_train_epoch(domain_idx, split, max_steps)
        if finetune not in self._epoch_fns:
            tx = self.finetune_tx if finetune else self.tx
            self._epoch_fns[finetune] = make_train_epoch(
                make_train_step(self.model, tx, self.step_cfg))
        return self._epoch_fns[finetune](state, stacked)

    def eval_stack(self, mode: str, domain_idx: int) -> Dict[str, torch.Tensor]:
        """A domain's val or test split as {col: [S, B]} in natural order,
        made once."""
        key = (mode, domain_idx)
        if key not in self._eval_stacks:
            self._eval_stacks[key] = self.stack_split(self._splits(mode)[domain_idx],
                                                      shuffle=False)
        return self._eval_stacks[key]

    def evaluate_domain(self, mode: str, domain_idx: int, params,
                        batch_stats) -> Tuple[float, float]:
        """(loss, AUC) of one domain's split with ``params`` and the batch
        statistics ``batch_stats`` (JAX ``evaluate_domain``,
        trainer.py:397-405; ``steps.make_eval_epoch``, K2 with ids [B]); one
        host read."""
        if self._eval_epoch is None:
            self._eval_epoch = make_eval_epoch(self.model, self.step_cfg)
        loss, auc = self._eval_epoch(params, self.eval_stack(mode, domain_idx), batch_stats)
        both = trace.to_host(torch.stack([loss, auc]))
        return float(both[0]), float(both[1])

    # ---------------- evaluation ----------------

    def _splits(self, mode: str):
        if mode not in ("val", "test"):
            raise ValueError(f"mode must be val or test, not {mode!r}")
        return {"val": self.dataset.val, "test": self.dataset.test}[mode]

    def eval_block(self, mode: str) -> Dict[str, torch.Tensor]:
        """Device-resident {col: [D, S, B]} eval block of a split, made once."""
        if mode not in self._eval_blocks:
            self._eval_blocks[mode] = fused.stack_domains_eval(
                self._splits(mode), self.dataset.batch_size, self.device)
        return self._eval_blocks[mode]

    def eval_steps_per_domain(self, mode: str) -> List[int]:
        """Per-domain real eval step counts ceil(n_d / B)."""
        return fused.domain_step_counts(self._splits(mode), self.dataset.batch_size)

    def fused_eval_fn(self):
        """The all-domain lane eval (fused.make_fused_eval): eval_all(params,
        block, stats) -> ([D] losses, [D] AUCs), params lane-stacked or
        shared, one batch-statistics tree every lane reads."""
        if self._eval_fn is None:
            self._eval_fn = fused.make_fused_eval(self.model, self.step_cfg)
        return self._eval_fn

    def val_and_test(self, mode: str, params_fn: Optional[Callable[[int], dict]] = None,
                     params=None) -> Tuple[float, float, Dict, Dict]:
        """Every domain's loss and AUC on a split -> (macro loss, macro AUC,
        per-domain dicts), as one lane eval: domain d is lane d.
        Every domain reads the state's current batch statistics (its own row
        of a PartitionedNorm's), as the JAX package's evals do, whatever
        weights it is given.

        ``params_fn(d)`` gives domain d's params (MAMDR's merged weights,
        specific_base_model.py:64-97); they are stacked into lanes, a leaf
        that is one tensor for every domain kept unstacked. Else every
        domain reads ``params`` (default: the current state's). The best
        checkpoint's reload for test is the caller's (strategies keep their
        best weights). The [D] results are read in one host sync.
        """
        if params_fn is not None:
            per = [params_fn(i) for i in range(self.dataset.n_domain)]
            params = trees.tree_map(
                lambda *xs: xs[0] if all(x is xs[0] for x in xs) else torch.stack(xs), *per)
        elif params is None:
            params = self.state.params
        losses, aucs = self.fused_eval_fn()(params, self.eval_block(mode),
                                            stats=self.state.batch_stats)
        return self.summarize(mode, *self.domain_dicts(losses, aucs))

    @staticmethod
    def domain_dicts(losses: torch.Tensor, aucs: torch.Tensor) -> Tuple[Dict, Dict]:
        """[D] losses and AUCs on the device -> per-domain dicts (one read)."""
        both = trace.to_host(torch.stack([losses, aucs]))
        return ({str(i): float(v) for i, v in enumerate(both[0])},
                {str(i): float(v) for i, v in enumerate(both[1])})

    def summarize(self, mode: str, domain_loss: Dict, domain_auc: Dict):
        """(macro loss, macro AUC, domain_loss, domain_auc); logs the event
        and, when verbose, prints the table (trainer.py:486-514)."""
        avg_loss = sum(domain_loss.values()) / len(domain_loss)
        avg_auc = sum(domain_auc.values()) / len(domain_auc)
        epoch = self._eval_epoch_counter
        self.metrics.log_eval(mode, epoch, avg_loss, avg_auc, domain_auc)
        if self.tb.enabled:  # weighted_auc is paid for only when TensorBoard is on
            self.tb.log_eval(mode, epoch, avg_loss, avg_auc, domain_auc,
                             weighted_auc=self.weighted_auc(mode, domain_auc))
        if mode == "val":
            self.tb.log_histograms(epoch, self.state.params, self.shard_axes)
            if self.tb.write_grads and self.tb.histograms_due(epoch):
                self.tb.log_grad_histograms(epoch, self._sample_grads(), self.shard_axes)
            self._eval_epoch_counter += 1
        if self.verbose:
            print(f"Loss: {domain_loss}")
            print("AUC: ")
            for k, v in domain_auc.items():
                print(f"{k}: {v}")
            w_auc = self.weighted_auc(mode, domain_auc)
            print(f"Overall {mode} Loss: {avg_loss}, AUC: {avg_auc}, Weighted AUC: {w_auc}")
        return avg_loss, avg_auc, domain_loss, domain_auc

    def _sample_batch(self) -> Dict[str, torch.Tensor]:
        """The first (at most 2) train rows of domain 0, weight 1, on the
        device (JAX ``_sample_batch``, trainer.py:276-300); on a mesh at
        least one row a data rank, and a domain 0 with fewer train rows
        than data ranks is refused, as there."""
        d0 = self.dataset.train[0]
        n = min(2, d0.n)
        if self.mesh is not None:
            if d0.n < self.mesh.data:
                raise ValueError(
                    f"domain 0 has {d0.n} train rows but the mesh data axis has "
                    f"{self.mesh.data} ranks; the sample batch must divide the data axis "
                    "— use a smaller mesh or more data")
            n = max(n, self.mesh.data)
        cols = {k: torch.from_numpy(np.ascontiguousarray(getattr(d0, k)[:n])).to(self.device)
                for k in COLUMNS}
        cols["weight"] = torch.ones((n,), dtype=torch.float32, device=self.device)
        return cols

    def _sample_grads(self):
        """The total loss's gradient on ``_sample_batch`` over the WHOLE
        params tree, frozen tables included, dropout off and the norms in
        eval mode reading the state's statistics: what ``jax.grad`` of the
        JAX package's loss gives (trainer.py:302-314). A frozen table's l2
        term is a constant, so its gradient is the gather's alone; a leaf
        the loss does not reach gets zeros. Autograd through the model's
        forward (K2 with its autograd rule), never K1.

        On a mesh, through the mesh lookup: a split leaf's gradient is this
        rank's part of it. On a data axis above 1 each data rank takes its
        rows of the batch, its data loss's gradient weighted by its rows'
        share of the weights, and these are summed over the data group in
        one ``all_reduce`` before the l2 term's gradient is added."""
        batch = self._sample_batch()
        live = trees.tree_map(lambda x: x.detach().requires_grad_(True), self.state.params)
        leaves = trees.leaves(live)
        kw = {"stats": self.state.batch_stats} if self.model.has_batch_stats else {}
        mesh = self.mesh
        with torch.enable_grad():
            if mesh is None or mesh.data == 1:
                loss = self.loss_fn(live, batch, **kw)[0]
                got = torch.autograd.grad(loss, leaves, allow_unused=True)
            else:
                local = {k: v[data_rows(mesh, v.shape[0])] for k, v in batch.items()}
                loss, data_loss = self.loss_fn(live, local, **kw)[:2]
                share = (torch.clamp(torch.sum(local["weight"]), min=1.0)
                         / torch.clamp(torch.sum(batch["weight"]), min=1.0))
                data_g = torch.autograd.grad(data_loss * share, leaves, retain_graph=True,
                                             allow_unused=True)
                # the l2 term alone: the data loss's path gets 1 - 1 = 0
                l2_g = torch.autograd.grad(loss - data_loss, leaves, allow_unused=True)
                flat = all_reduce_sum_(mesh, torch.cat([
                    (torch.zeros_like(x) if g is None else g).reshape(-1)
                    for g, x in zip(data_g, leaves)]), DATA_AXIS)
                got = [s.view(x.shape) + (0.0 if g is None else g) for s, g, x in zip(
                    torch.split(flat, [x.numel() for x in leaves]), l2_g, leaves)]
        got = dict(zip(trees.param_names(live), got))
        return trees.named_tree_map(
            lambda n, x: torch.zeros_like(x) if got[n] is None else got[n], live)

    def weighted_auc(self, mode: str, domain_auc: Dict[str, float]) -> float:
        """Example-weighted AUC (base_model.py:157-175)."""
        info = self.dataset.dataset_info
        tag = "n_val" if "val" in mode else ("n_test" if "test" in mode else "n_train")
        num = sum(info[k][tag] * v for k, v in domain_auc.items())
        den = sum(info[k][tag] for k in domain_auc)
        return num / den

    # ---------------- checkpoints ----------------

    def save_checkpoint(self, params=None) -> None:
        """Keep ``params`` (default: the state's) as the best, on the device,
        and write them to ``checkpoint_path``: the params only, no batch
        statistics, as the JAX package writes them."""
        params = params if params is not None else self.state.params
        self.best_params = params
        with trace.span("trainer.snapshot"):
            self.save_tree(self.checkpoint_path, params)

    def load_checkpoint(self):
        """The best-params file, on every rank: the whole tree read, then this
        rank's rows kept."""
        if self.mesh is None:
            return checkpoints.load_pytree(self.checkpoint_path, self.state.params)
        return self._shard(checkpoints.load_pytree(
            self.checkpoint_path, self._whole_like(self.state.params)), self.shard_axes)

    def _whole_like(self, tree):
        """Uninitialised tensors shaped as ``whole(tree)`` would give (a
        template to read a whole tree into)."""
        def like(a, x):
            if not a or x.dim() < -a:
                return x
            shape = list(x.shape)
            shape[a] *= self.mesh.table
            return x.new_empty(shape)

        return trees.tree_map(like, self.shard_axes, tree)

    def _whole_slots(self, opt, tx):
        """A flat Adam state of ``tx`` over this rank's leaves -> the whole
        tree's (``whole_flat_slots``); any other state as it is."""
        if self.mesh is None or not hasattr(opt, "mu"):
            return opt
        mu, nu = (whole_flat_slots(v, self.state.params, self.shard_axes, tx, self.mesh)
                  for v in (opt.mu, opt.nu))
        return type(opt)(count=opt.count, mu=mu, nu=nu)

    def _whole_slots_like(self, opt, tx):
        """A template of ``_whole_slots(opt, tx)``."""
        if self.mesh is None or not hasattr(opt, "mu"):
            return opt
        whole = self._whole_like(self.state.params)
        n = sum(x.numel() for x, m in zip(trees.leaves(whole), tx._trainable) if m)
        lead = opt.mu.shape[:-1]
        return type(opt)(count=opt.count, mu=opt.mu.new_empty((*lead, n)),
                         nu=opt.nu.new_empty((*lead, n)))

    def _cut_slots(self, opt, tx):
        """The inverse of ``_whole_slots``: this rank's segments kept."""
        if self.mesh is None or not hasattr(opt, "mu"):
            return opt
        whole = self._whole_like(self.state.params)
        mu, nu = (shard_flat_slots(v, whole, self.shard_axes, tx, self.mesh)
                  for v in (opt.mu, opt.nu))
        return type(opt)(count=opt.count, mu=mu, nu=nu)

    @contextlib.contextmanager
    def profiled(self, name: str, span: str = "trainer.epoch", epoch: int = 0):
        """An epoch of a train loop, a separate run or the finetune stage as
        the span ``span``; with ``train.profile_dir`` (on rank 0) under the
        profiler with spans on (``trace.profiled``):
        ``<profile_dir>/<name>.trace.json``, and an ``epoch_counters`` event
        naming it in the metrics log."""
        profile_dir = self.config.train.profile_dir if self.rank0 else ""
        with trace.profiled(profile_dir, name, lambda c: self.metrics.log(
                "epoch_counters", trace=name, epoch=epoch, counters=c)):
            with trace.span(span):
                yield

    def epochs(self, start: int = 0):
        """The train loop's epoch numbers, ``start`` to ``train.epoch``: each
        one's iteration (its epoch, validation and snapshots, up to the
        loop's next step or its ``break``) is ``profiled`` as
        ``epoch_<n>``."""
        for epoch in range(start, self.config.train.epoch):
            with self.profiled(f"epoch_{epoch}", epoch=epoch):
                yield epoch

    def resume_due(self, epoch: int) -> bool:
        """Whether the resume snapshot is written after ``epoch``: every
        ``train.resume_every`` epochs, never when that is 0."""
        every = self.config.train.resume_every
        return every > 0 and (epoch + 1) % every == 0

    def save_resume_state(self, epoch: int, extra_trees=None, optimizers=None) -> None:
        """The resume snapshot after ``epoch`` in ``resume_dir``: the state,
        the early stop, ``np_rng`` and both torch generators (``_seed_gen``,
        ``gen``), with the strategy's ``extra_trees``; ``optimizers`` names
        the flat Adam whose state an extra tree is ({name: tx}). On a mesh
        rank 0 writes the whole of each while the other ranks wait: every
        split leaf gathered over the table group at its padded row count,
        flat Adam's slots in the whole tree's order (the JAX package's file);
        the random streams and the early stop are rank 0's, the same on every
        rank."""
        optimizers = optimizers or {}
        with trace.span("trainer.snapshot"):
            state = self.state
            if self.mesh is not None:
                state = whole_train_state(state, self.shard_axes, self.mesh, self.tx)
            extra = {k: self._whole_slots(v, optimizers[k]) if k in optimizers
                     else self.whole(v) for k, v in (extra_trees or {}).items()}
            if self.rank0:
                checkpoints.save_train_state(
                    self.resume_dir, self._snapshot_layout(state), epoch, self.stopper,
                    self.np_rng, extra,
                    generators={"seed_gen": self._seed_gen, "gen": self.gen})
            self._barrier()

    def _snapshot_layout(self, state: TrainState) -> TrainState:
        """``state`` (whole) as the resume snapshot stores it: with
        ``flat_optimizer`` false the Adam slots in the JAX package's per-leaf
        optax layout (``FlatAdam.to_optax``), else as they are."""
        if getattr(self.tx, "optax_path", None) is None:
            return state
        return state.replace(opt_state=self.tx.to_optax(state.opt_state, state.params))

    def try_resume(self, extra_templates=None, optimizers=None):
        """With ``train.resume`` and a snapshot in ``resume_dir``: restore the
        state, the early stop's four fields, ``np_rng``'s bit-generator state
        and both torch generators, and return (the next epoch, {name: extra
        tree} of ``extra_templates``' names found); else None.
        ``optimizers`` as in ``save_resume_state``. On a mesh rank 0 alone
        looks for the snapshot and tells the others; every rank reads the
        whole files and keeps its rows of the split leaves and of their Adam
        slots."""
        if not self.config.train.resume:
            return None
        found = self.rank0 and checkpoints.has_train_state(self.resume_dir)
        if self.mesh is not None:
            found = broadcast_object(found)
        if not found:
            return None
        optimizers = optimizers or {}
        template = self.state
        templates = dict(extra_templates or {})
        if self.mesh is not None:
            whole = self._whole_like(self.state.params)
            template = template.replace(params=whole, opt_state=self._whole_slots_like(
                self.state.opt_state, self.tx))
            templates = {k: self._whole_slots_like(v, optimizers[k]) if k in optimizers
                         else self._whole_like(v) for k, v in templates.items()}
        state, epoch, st, np_state, extras = checkpoints.load_train_state(
            self.resume_dir, self._snapshot_layout(template), templates)
        if getattr(self.tx, "optax_path", None) is not None:
            state = state.replace(opt_state=self.tx.from_optax(state.opt_state))
        if self.mesh is not None:
            state = shard_train_state(state, self.shard_axes, self.mesh, self.tx)
            extras = {k: v if k == "generators" else self._cut_slots(v, optimizers[k])
                      if k in optimizers else self._shard(v, self.shard_axes)
                      for k, v in extras.items()}
        self.state = state
        gens = extras.pop("generators")
        self._seed_gen.set_state(gens["seed_gen"])
        self.gen.set_state(gens["gen"])
        self.stopper.patience = st["patience"]
        self.stopper.counter = st["counter"]
        self.stopper.best_metric = st["best_metric"]
        self.stopper.early_stop = st["early_stop"]
        self.np_rng.bit_generator.state = np_state
        if self.verbose:
            print(f"Resumed from {self.resume_dir} at epoch {epoch + 1}")
        return epoch + 1, extras

    def save_result(self, avg_loss, avg_auc, domain_loss, domain_auc) -> str:
        """The run's result folder (reference run.py:86-89, JAX
        trainer.py:512-539): ``result_dir/loss_X_auc_Y_<time>/`` with
        ``dataset_info.json``, ``config.json.example``, ``result.json`` and
        ``model_parameters.npz`` — the best params, the ones that gave the
        test metrics (the state's when no checkpoint was kept). Returns the
        folder's path."""
        folder = "loss_{:.3f}_auc_{:.3f}_{}".format(
            avg_loss, avg_auc, time.strftime("%a-%b-%d-%H-%M-%S"))
        if self.mesh is not None:
            folder = broadcast_object(folder)
        result_path = osp.join(self.result_dir, folder)
        params = self.whole(self.best_params if self.best_params is not None
                            else self.state.params)
        if not self.rank0:
            self._barrier()
            return result_path
        os.makedirs(result_path, exist_ok=True)
        with open(osp.join(result_path, "dataset_info.json"), "w") as f:
            json.dump(self.dataset.dataset_info, f)
        with open(osp.join(result_path, "config.json.example"), "w") as f:
            json.dump(self.config.to_dict(), f)
        with open(osp.join(result_path, "result.json"), "w") as f:
            json.dump({"avg_loss": avg_loss, "avg_auc": avg_auc,
                       "domain_loss": domain_loss, "domain_auc": domain_auc}, f)
        checkpoints.save_pytree(osp.join(result_path, "model_parameters.npz"), params)
        self._barrier()
        return result_path
