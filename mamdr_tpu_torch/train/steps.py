"""The train step shared by every execution path, and its loss and optimizer.

Counterpart of ``mamdr_tpu/train/steps.py`` for every base model the port
builds:

  - binary cross-entropy on logits, masked weighted mean
    sum(w*bce)/max(sum(w), 1) (Keras weighted loss with 0/1 weights);
  - l2 1e-5 on the embedding tables (the wide term's dim-1 tables too),
    frozen tables contributing a constant;
  - optional Kendall uncertainty weighting per domain: data loss
    bce/var^2 + log(var), var = log_vars[domain of the batch] (reference
    model_zoo/uncertainty_weight/weighted_loss.py:29-42);
  - the loss gradient (``make_loss_grad``, the gate of the JAX package's
    ``maybe_make_fast_loss_grad``, ops/fused_mlp_step.py:220-229): the plain
    MLP takes the fused tower gradient (kernels K1 and K2,
    ops/fused_mlp_step.py), for one tower or for L lanes; anything else —
    every other base model, and the uncertainty-weighted loss — takes
    autograd (``make_autograd_loss_grad``) through the model's forward pass
    (one tower) or its lane forward (``apply_lanes``, L lanes), whose field
    gather is K2 with its autograd rule;
  - the batch statistics of a model with a norm (STAR, ``model.init_stats``):
    the forward reads them (``model_logits``), a train-mode forward returns
    them updated, and they ride through the loss gradient as aux, as the
    JAX package's ``mutable=["batch_stats"]`` does (steps.py:84-113);
  - one train step = the loss gradient, the optimizer (flat Adam, or masked
    SGD in the finetune stage), and the all-pad gate: a batch whose weights
    sum to 0 leaves params, optimizer slots, batch statistics and ``step``
    exactly as they were (steps.py:148-165). The gate is taken on the
    device, so a step never waits for the host: a ``torch.where``, and for
    flat Adam on the card part of kernel K4, the one pass that updates,
    applies and gates the trainable leaves and the slots
    (``FlatAdam.step``). Its dropout seeds are one a dropout site of the
    model (``n_dropout_sites``);
  - the subset lane step (``make_subset_train_step``, steps.py:171-236): the
    very same step function over lane-stacked state that carries only
    trainable leaves, with the gate taken per lane;
  - the meta-gradient accumulator's step (``make_accum_grad_fn``,
    steps.py:239-262): the gradient of the total loss at fixed params with
    dropout off and the norms in eval mode — through K1 at rate 0 where the
    gate allows;
  - the per-call epochs over one domain's [S, B] batches
    (``TrainFns.train_epoch`` / ``eval_epoch``, steps.py:263-293):
    ``make_train_epoch`` runs a train step on each batch in order and
    returns the mean data loss; ``make_eval_epoch`` gives one domain's loss
    and 500-threshold AUC, one tower a batch (ids [B]). Neither reads
    anything back to the host.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from mamdr_tpu_torch.metrics.auc import auc_init, auc_result, auc_update
from mamdr_tpu_torch.models.deepctr import MLP
from mamdr_tpu_torch.models.embeddings import frozen_mask, table_mask
from mamdr_tpu_torch.ops.embedding_lookup import gather_fields
from mamdr_tpu_torch.ops.fast_random import step_seeds
from mamdr_tpu_torch.ops.fused_adam_update import gated
from mamdr_tpu_torch.ops.fused_mlp_step import make_fast_loss_grad
from mamdr_tpu_torch.parallel.mesh import table_sum
from mamdr_tpu_torch.parallel.trainer_sharding import make_data_parallel_loss_grad
from mamdr_tpu_torch.train.flat_optimizer import FlatAdam, MaskedSgd
from mamdr_tpu_torch.train.state import TrainState
from mamdr_tpu_torch.utils import trace, trees


class StepConfig(NamedTuple):
    l2_emb: float = 1e-5
    emb_trainable: bool = True
    uncertainty_weight: bool = False
    # on a (data, table) mesh: the model's field gather over it
    # (parallel/embedding_shard.py::MeshLookup); None on one device
    lookup: Optional[Callable] = None


def field_gather(cfg: StepConfig, gather: Optional[Callable] = None) -> Callable:
    """The field gather a function built from ``cfg`` uses: ``gather`` when
    given, else the mesh's lookup, else K2's wrapper."""
    return gather or cfg.lookup or gather_fields


def weighted_bce(logits, labels, weights):
    """sum(w * bce) / max(sum(w), 1) over the last axis; [B] gives [], [L, B]
    gives [L]. ``bce`` is optax's ``sigmoid_binary_cross_entropy``,
    -y log σ(z) - (1 - y) log σ(-z), whose autograd gradient is σ(z) - y at
    every z: at a logit of exactly 0 (a row whose ReLUs are all dead, under
    a head with no bias or a zero one) a form through clamp and abs would
    give 1 - y where ``jax.grad`` gives 0.5 - y."""
    bce = (-labels * torch.nn.functional.logsigmoid(logits)
           - (1.0 - labels) * torch.nn.functional.logsigmoid(-logits))
    denom = torch.clamp(torch.sum(weights, dim=-1), min=1.0)
    return torch.sum(bce * weights, dim=-1) / denom


def make_l2_term(model, cfg: StepConfig):
    """l2_term(model_params, lanes=False) -> l2 * sum(table^2) over the
    model's tables (``models/embeddings``' rule, read here once): one value,
    or over lanes [L] where a table carries a lane axis (``model.lane_axes``);
    frozen tables detached (a constant); a row-sharded table's sum taken over
    its table group."""
    l2, lookup = cfg.l2_emb, cfg.lookup
    whole = model.param_tree()
    tables = [(name.split("/"), x.dim(), frozen,
               lookup is not None and lookup.sharded_leaf(name))
              for (name, x), is_table, frozen in zip(
                  trees.leaves_with_names(whole), trees.leaves(table_mask(whole)),
                  trees.leaves(frozen_mask(whole, cfg.emb_trainable)))
              if is_table]

    def l2_term(model_params, lanes: bool = False):
        if l2 <= 0.0:
            return 0.0
        total = 0.0
        for path, rank, frozen, sharded in tables:
            x = trees.at(model_params, path)
            t = (torch.sum(torch.square(x.flatten(1)), dim=1) if lanes and x.dim() > rank
                 else torch.sum(torch.square(x)))
            if sharded:
                t = table_sum(lookup.mesh, t)
            if frozen:
                t = t.detach()
            total = total + t
        return l2 * total

    return l2_term


def model_logits(model, model_params, batch, seeds=None, gather=gather_fields,
                 stats=None, train: bool = False):
    """(logits, batch statistics): the model's forward on a batch, one tower
    (columns [B], ``model.apply``) or L lanes (columns [L, B],
    ``model.apply_lanes``); dropout iff ``seeds`` are given, the fields by
    ``gather`` (K2's wrapper by default). A model with batch statistics
    reads ``stats`` and, when ``train``, returns them updated (the norms
    take the batch's own statistics); for any other model ``stats`` passes
    through unread."""
    uid, pid, dom = batch["uid"], batch["pid"], batch["domain"]
    lanes = uid.dim() == 2
    if not model.has_batch_stats:
        logits = (model.apply_lanes(model_params, uid, pid, dom, gather, seeds) if lanes
                  else model.apply(model_params, uid, pid, dom, seeds, gather))
        return logits, stats
    kw = {"stats": stats, "train": train}
    out = (model.apply_lanes(model_params, uid, pid, dom, gather, seeds, **kw) if lanes
           else model.apply(model_params, uid, pid, dom, seeds, gather, **kw))
    return out if train else (out, stats)


def _losses(model, cfg: StepConfig, l2_term, params, batch, seeds, gather, stats=None,
            train: bool = False):
    """(total loss, data loss, logits, batch statistics) of a batch through
    ``model_logits``: one tower (columns [B]; losses []) or L lanes (columns
    [L, B]; losses [L], lane l reading its own leaves where they carry a
    lane axis, ``model.lane_axes``). Under uncertainty weighting var is the
    ``log_vars`` entry (a lane's own, where they carry a lane axis) for the
    batch's domain; the l2 term is ``l2_term``'s (``make_l2_term``), a lane's
    own tables' over lanes."""
    mp = params["model"]
    logits, new_stats = model_logits(model, mp, batch, seeds, gather, stats, train)
    data_loss = weighted_bce(logits, batch["label"], batch["weight"])
    if cfg.uncertainty_weight:
        data_loss = uncertainty_loss(data_loss, params["uncertainty"]["log_vars"],
                                     batch["domain"])
    l2 = l2_term(mp, lanes=batch["uid"].dim() == 2)
    return data_loss + l2, data_loss, logits, new_stats


def make_loss_fn(model, cfg: StepConfig, gather=None):
    """loss_fn(params, batch, seeds=None, probs=False, stats=None,
    train=False) -> (loss, data_loss), then the probabilities when
    ``probs``, then the batch statistics when ``stats`` is given (a model
    with a norm: updated when ``train``, else ``stats``): the model's
    forward pass on one tower's batch (``model_logits``) and the loss on
    it."""
    gather = field_gather(cfg, gather)
    l2_term = make_l2_term(model, cfg)

    def loss_fn(params, batch, seeds=None, probs: bool = False, stats=None,
                train: bool = False):
        loss, data_loss, logits, new_stats = _losses(model, cfg, l2_term, params, batch, seeds,
                                                     gather, stats, train)
        out = (loss, data_loss)
        if probs:
            out += (torch.sigmoid(logits),)
        if stats is not None:
            out += (new_stats,)
        return out

    return loss_fn


def uncertainty_loss(data_loss, log_vars, domain):
    """bce/var^2 + log(var), var = log_vars[the batch's domain]: log_vars
    [D, 1] read by every lane, or [L, D, 1] a lane's own (batch columns
    [L, B]); one tower's [D, 1] with domain [B]."""
    dom = domain[..., 0].long()
    if log_vars.dim() == 3:
        var = log_vars[torch.arange(log_vars.shape[0], device=dom.device), dom, 0]
    else:
        var = log_vars[dom, 0]
    return data_loss / torch.square(var) + torch.log(var)


def make_autograd_loss_grad(model, cfg: StepConfig, gather=None):
    """f(params, batch, seeds, train=True, stats=None) -> (data_loss, grads)
    by autograd: the contract of ``make_fast_loss_grad``; with ``stats``
    (a model with batch statistics) -> (data_loss, grads, new stats), the
    statistics updated when ``train`` (the norms then normalise with the
    batch's own, and the gradient flows through them), read otherwise.
    Batch columns [B] (one tower, the model's ``apply``; ``data_loss`` [])
    or [L, B] (L lanes, the model's lane forward ``apply_lanes``;
    ``data_loss`` [L], seeds
    [L, n_dropout_sites], and ``grads`` the gradient of the SUM of the
    lanes' losses, which are independent: a lane-stacked leaf gets each
    lane's own gradient). ``grads`` has the structure of ``params`` with
    ``None`` at frozen tables (the linear user/item ones too); a trainable
    leaf the loss does not reach gets zeros (PLE's last shared gate), as
    ``jax.grad`` gives. Dropout from ``seeds`` when ``train``, off
    otherwise. The tables' gradients come from K2's autograd rule
    (``gather_fields``; a check on the card passes ``gather``, its plain
    version). The JAX package takes this route (``jax.value_and_grad`` of
    its loss, vmapped over the lanes) wherever its fused kernel is not
    eligible."""
    gather = field_gather(cfg, gather)
    l2_term = make_l2_term(model, cfg)
    like = {"model": model.param_tree()}  # the tree a step reads
    if cfg.uncertainty_weight:
        like["uncertainty"] = {"log_vars": None}
    frozen = frozen_mask(like, cfg.emb_trainable)

    def loss_grad(params, batch, seeds, train: bool = True, stats=None):
        inputs = []

        def require_grad(x, f):
            if not f:
                x = x.detach().requires_grad_(True)
                inputs.append(x)
            return x

        live = trees.tree_map(require_grad, params, frozen)
        s = seeds if train else None
        with torch.enable_grad():
            loss, data_loss, _, new_stats = _losses(model, cfg, l2_term, live, batch, s,
                                                    gather, stats, train)
            got = iter(torch.autograd.grad(torch.sum(loss), inputs, allow_unused=True))

        def grad_of(x, f):
            if f:
                return None
            g = next(got)
            return torch.zeros_like(x) if g is None else g

        grads = trees.tree_map(grad_of, live, frozen)
        if stats is None:
            return data_loss.detach(), grads
        return data_loss.detach(), grads, trees.tree_map(torch.Tensor.detach, new_stats)

    return loss_grad


def make_loss_grad(model, cfg: StepConfig):
    """The loss gradient a train or accumulate step takes (the gate of the
    JAX package's ``maybe_make_fast_loss_grad``, ops/fused_mlp_step.py:220-229):
    the plain MLP computing in float32 without uncertainty weighting takes
    the fused kernel path (``make_fast_loss_grad``: K2, then K1 or
    K1-lanes), anything else — the other base models, a model with batch
    statistics (STAR), the uncertainty-weighted loss, an MLP whose tower
    computes in bfloat16 (K1 computes float32; JAX fused_mlp_step.py:227) —
    autograd (``make_autograd_loss_grad``), for one tower or for lanes.

    On a mesh (``cfg.lookup``) the fields come from the mesh's lookup, and a
    one-tower batch — the whole batch, on every rank — is data-parallel
    (``parallel/trainer_sharding.make_data_parallel_loss_grad``: each data
    rank its rows, the gradients summed over the data group, the l2 terms
    after the sum); a lane batch is computed whole where it is given (the
    DR lanes are split over the data group by lane)."""
    fast = (isinstance(model, MLP) and model.compute_dtype == "float32"
            and not model.has_batch_stats and not cfg.uncertainty_weight)
    build = make_fast_loss_grad if fast else make_autograd_loss_grad
    lanes = build(model, cfg)
    if cfg.lookup is None:
        return lanes
    one = make_data_parallel_loss_grad(build(model, cfg._replace(l2_emb=0.0)), model, cfg)

    def loss_grad(params, batch, seeds, train: bool = True, **kw):
        return (one if batch["uid"].dim() == 1 else lanes)(params, batch, seeds, train, **kw)

    return loss_grad


def make_train_step(model, tx, cfg: StepConfig, loss_grad: Optional[Callable] = None,
                    combine: Optional[Callable] = None):
    """(state, batch) -> (state, data_loss), for one tower (batch columns
    [B], ``step`` []) or for L lanes at once (every carried leaf [L, ...],
    batch columns [L, B], ``step`` and ``seed`` [L]): seeds, loss and
    gradient, the optimizer and the gate all broadcast over the lane axis,
    and the gate is taken per lane; the optimizer state keeps its own type
    (flat Adam's slots, or SGD's empty state). ``loss_grad`` defaults to
    ``make_loss_grad``'s choice — K1 (one tower) or K1-lanes for the plain
    MLP, and for every other model or loss autograd through the model's
    forward or, over lanes, its lane forward; either way the fields come
    from one K2 launch a step. ``combine`` maps the carried params to the
    tree the loss reads (make_subset_train_step). A step draws one dropout
    seed a dropout site of the model (``model.n_dropout_sites``: the MLP's
    layers; an MTL model's bottom, expert, gate and tower layers). A model
    with batch statistics carries them in ``state.batch_stats`` ([L]-stacked
    over lanes): the step's forward updates them, under the same gate."""
    if loss_grad is None:
        loss_grad = make_loss_grad(model, cfg)
    n_layers = model.n_dropout_sites
    has_stats = model.has_batch_stats

    def train_step(state: TrainState, batch):
        with trace.span("step"):
            with trace.span("step.seeds"):
                seeds = step_seeds(state.seed, state.step, n_layers)
            params = state.params if combine is None else combine(state.params)
            with trace.span("step.loss_grad"):
                if has_stats:
                    data_loss, grads, new_stats = loss_grad(params, batch, seeds, train=True,
                                                            stats=state.batch_stats)
                else:
                    data_loss, grads = loss_grad(params, batch, seeds, train=True)
            with trace.span("step.gate"):
                has_data = torch.sum(batch["weight"], dim=-1) > 0.0  # [] or [L]
            # the optimizer, its apply and the gate of params and slots (flat
            # Adam on the card: one launch of K4)
            new_params, new_opt = tx.step(state.params, grads, state.opt_state, has_data)
            with trace.span("step.gate"):
                new_state = state.replace(
                    params=new_params,
                    opt_state=new_opt,
                    batch_stats=(trees.tree_map(
                        lambda n, o: o if n is o else gated(has_data, n, o), new_stats,
                        state.batch_stats) if has_stats else state.batch_stats),
                    step=state.step + has_data.to(state.step.dtype),
                )
            return new_state, data_loss

    return train_step


def make_subset_train_step(model, tx, cfg: StepConfig, frozen_mask, frozen_full,
                           loss_grad: Optional[Callable] = None):
    """Train step over L lanes whose carried params hold only the TRAINABLE
    subset. Returns (train_step, to_sub, combine).

    The carried state is lane-stacked: every trainable leaf [L, ...],
    optimizer slots [L, n], ``step`` [L], ``seed`` [L]; batch columns [L, B].
    Frozen leaves (``frozen_mask`` True: the pretrained user/item tables
    when emb_trainable is false) are captured once from ``frozen_full`` and
    shared by every lane: ``to_sub(full)`` puts a scalar placeholder in
    their place, ``combine(sub)`` restores the one shared tensor, so L lanes
    never hold L copies of a table. ``train_step`` is make_train_step's step
    reading ``combine(params)``: one call advances all lanes through the
    lane-batched kernel K1 (the plain MLP) or the autograd lane step (every
    other model or loss), and a lane whose batch weights sum to 0 keeps
    its params, slots and step exactly while the others move, with no host
    sync.
    """

    def to_sub(full):
        return trees.tree_map(lambda f, x: x.new_zeros(()) if f else x, frozen_mask, full)

    def combine(sub):
        return trees.tree_map(lambda f, fr, x: fr if f else x,
                              frozen_mask, frozen_full, sub)

    return make_train_step(model, tx, cfg, loss_grad, combine), to_sub, combine


def make_accum_grad_fn(model, cfg: StepConfig, loss_grad: Optional[Callable] = None):
    """grad_fn(params, batch, stats=None) -> grads of the total loss at fixed
    params with dropout off and the norms in eval mode, reading ``stats``
    (a model with batch statistics; any other model ignores it) and leaving
    them as they are (JAX
    ``make_accum_grad_fn``, steps.py:239-262: the reference's accumulate
    function runs at learning phase 0, maml.py:196-234).
    ``grads`` has the structure of ``params`` with ``None`` at frozen tables.
    ``loss_grad`` defaults to ``make_loss_grad``'s choice: for the plain MLP
    kernel K2 and then K1 at dropout rate 0, which builds no mask and is
    handed zero seeds (no seed is drawn); a check on the card passes a loss
    gradient built on the plain versions."""
    if loss_grad is None:
        loss_grad = make_loss_grad(model, cfg)
    n_layers = model.n_dropout_sites
    has_stats = model.has_batch_stats
    no_seeds = {}  # (device, batch shape) -> zero seeds, never read at rate 0

    def grad_fn(params, batch, stats=None):
        w = batch["weight"]
        key = (w.device, tuple(w.shape[:-1]))
        seeds = no_seeds.get(key)
        if seeds is None:
            seeds = no_seeds[key] = torch.zeros((*w.shape[:-1], n_layers),
                                                dtype=torch.int64, device=w.device)
        kw = {"stats": stats} if has_stats else {}
        return loss_grad(params, batch, seeds, train=False, **kw)[1]

    return grad_fn


def make_optimizer(name: str, learning_rate: float, params,
                   emb_trainable: bool = True, flat: bool = True):
    """Inner optimizer: flat Adam (TF1 AdamOptimizer defaults: b1=.9 b2=.999
    eps=1e-8) or plain SGD (the finetune stage's).

    When ``emb_trainable`` is false the user/item tables are frozen: no
    gradient, no update, no slots. ``flat`` false is the JAX package's
    per-leaf ``optax.adam`` (with frozen tables inside the masked chain): the
    same numbers, so the port runs the flat Adam and keeps only the optax
    state's layout for the resume snapshot (``FlatAdam.optax_path``).
    """
    if name not in ("adam", "sgd"):
        raise ValueError(f"unknown optimizer {name!r}")
    mask = trees.tree_map(lambda f: not f, frozen_mask(params, emb_trainable))
    if name == "sgd":
        return MaskedSgd(learning_rate, mask)
    per_leaf = ("0",) if emb_trainable else ("1", "inner_state", "0")
    return FlatAdam(learning_rate, mask, optax_path=None if flat else per_leaf)


def make_train_epoch(train_step: Callable):
    """train_epoch(state, stacked) -> (state, mean data loss): ``train_step``
    on each [B] batch of ``stacked`` ({col: [S, B]}) in order (JAX
    ``train_epoch``, steps.py:268-272). The loss stays on the device."""

    def train_epoch(state: TrainState, stacked):
        n_steps = stacked["weight"].shape[0]
        loss_sum = torch.zeros((), dtype=torch.float32, device=stacked["weight"].device)
        for s in range(n_steps):
            state, loss = train_step(state, {k: v[s] for k, v in stacked.items()})
            loss_sum = loss_sum + loss
        return state, loss_sum / n_steps

    return train_epoch


def make_eval_epoch(model, cfg: StepConfig, gather=None):
    """eval_epoch(params, stacked, stats=None) -> (loss, AUC), 0-d tensors on
    the device: one domain's [S, B] batches through the model's one-tower
    forward (K2 with ids [B]), dropout off, the norms in eval mode reading
    ``stats`` (JAX ``eval_epoch``, steps.py:274-293). The loss is the total
    loss (data loss plus the l2 term) averaged over the S batches, a partial
    batch by its weighted mean; the AUC is the 500-threshold ROC AUC of the
    confusion counts summed over every batch (pad rows carry weight 0)."""
    loss_fn = make_loss_fn(model, cfg, gather)

    def eval_epoch(params, stacked, stats=None):
        w = stacked["weight"]
        stats = stats if model.has_batch_stats else None
        counts = auc_init(device=w.device)
        loss_sum = torch.zeros((), dtype=torch.float32, device=w.device)
        with torch.no_grad():
            for s in range(w.shape[0]):
                b = {k: v[s] for k, v in stacked.items()}
                loss, _, probs = loss_fn(params, b, probs=True, stats=stats)[:3]
                loss_sum = loss_sum + loss
                with trace.span("eval.auc"):
                    counts = auc_update(counts, b["label"], probs, b["weight"])
        return loss_sum / w.shape[0], auc_result(counts)

    return eval_epoch
