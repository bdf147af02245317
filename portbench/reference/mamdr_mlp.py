"""Plain PyTorch reference of MAMDR epochs on the MLP tower.

What one epoch of ``mlp_meta_mamdr_finetune`` computes (MAMDR, ICDE'23:
Domain Negotiation then Domain Regularization), written out from the
method's description with nothing of the program under test:

- the tower: the user, item and domain rows concatenated, Dense -> ReLU ->
  inverted hash dropout per hidden layer, a bias-free one-unit logit;
- the loss: the weighted mean binary cross-entropy over a batch's rows plus
  l2 (1e-5) on the trainable embedding tables; gradients by autograd;
- Adam (b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias-corrected)
  over every trainable leaf; a batch whose weights are all 0 is no step;
- an epoch: the draws (the domain order shuffled, then each query domain's
  support domains, from numpy's ``default_rng``), then DN: from ``shared``,
  one pass over every domain in order, each domain's rows in a random order
  (a ``torch.rand`` key a row, real rows first), then shared += (θ - shared)
  * meta_lr; then DR: each query domain q in order, one after another, from
  the post-DN optimizer state and step count and a dropout stream of its
  own, for each support domain s: θ = shared + specific[q], an epoch on s,
  an epoch on q (at most ``reg_step`` batches when that is positive), then
  specific[q] += (θ - (shared + specific[q])) * meta_lr. The next epoch
  starts from the last query domain's optimizer state.

The random draws are the inputs' seeds worked out again: the numpy draws,
the shuffle keys (``torch.rand`` on the device, in the order the epoch
needs them: a [N_pad] draw per DN domain, then 2 * K [D, N_pad] draws for
the DR runs, support j before query j, row l for the l-th query domain),
and the dropout masks (``hashdrop``, seeded per step from a base seed and
the step count). Every meta parameter is trainable and every trainable
leaf a meta parameter (the frozen user and item tables are neither).

``precision`` "tf32" runs the products in TF32 (the control; on the CPU,
its operands rounded to TF32 before each product); ``slots`` "bfloat16"
keeps Adam's slots of the DR lanes in bfloat16 (the control of the passes
over the lane-stacked tables); ``fault`` "half_batch" drops the second half
of every batch (the mean taken over the rest).

The first DR step of every query domain is recorded: what its tower call
took and gave, and the lane's state before and after the step in the
comparison's pieces (``lane_pieces``). ``lane_step`` is the reference's
step of such a lane from a recorded state and the tower's outputs, and
``lane_fields`` its field rows: the comparison holds the program's first
DR lane-step to them.

``make_weights`` makes the weights that both sides are given, on the device
from a seed in a few large draws; ``problem`` is what the reference is
built from: the configuration's settings and the run's inputs.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench.reference.hashdrop import KeepMasks, lane_seeds, step_seeds

B1, B2, EPS = 0.9, 0.999, 1e-8
TABLES = ("user_emb", "item_emb", "domain_emb")
SAMPLE_ROWS = 1024


def table_rows(ids: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The rows of a table that a lane's pieces keep: those ``ids`` touch
    and ``SAMPLE_ROWS`` more drawn from a fixed seed, sorted, each once."""
    g = torch.Generator(device=ids.device).manual_seed(0)
    extra = torch.randperm(n_rows, generator=g, device=ids.device)[:SAMPLE_ROWS]
    return torch.unique(torch.cat([ids.reshape(-1).long(), extra]))


def adam(p, mu, nu, g, count: int, lr: float, slots: str = "float32"):
    """(p, mu, nu) after one Adam step at ``count`` (the step's own, from
    1), elementwise on tensors of any shape; ``slots`` "bfloat16" stores
    the slots in bfloat16."""
    mu = B1 * mu + (1.0 - B1) * g
    nu = B2 * nu + (1.0 - B2) * (g * g)
    if slots == "bfloat16":
        mu, nu = mu.to(torch.bfloat16).to(torch.float32), nu.to(torch.bfloat16).to(torch.float32)
    mu_hat = mu / (1.0 - B1 ** count)
    nu_hat = nu / (1.0 - B2 ** count)
    return p - lr * mu_hat / (torch.sqrt(nu_hat) + EPS), mu, nu


def leaf_order(n_hidden: int) -> Tuple[str, ...]:
    """Every leaf's name: the three tables, then W0, b0, ..., the logit Wl."""
    tower = [n for i in range(n_hidden) for n in (f"W{i}", f"b{i}")]
    return TABLES + tuple(tower) + ("Wl",)


# ---- the inputs both sides are given ----

Tree = Dict[str, torch.Tensor]


def shapes(cfg: Dict) -> Dict[str, Tuple[int, ...]]:
    dims = [3 * cfg["user_dim"], *cfg["hidden_dim"]]
    out = {"user_emb": (cfg["n_uid"], cfg["user_dim"]), "item_emb": (cfg["n_pid"], cfg["user_dim"]),
           "domain_emb": (cfg["n_domain"], cfg["user_dim"])}
    for i in range(len(cfg["hidden_dim"])):
        out[f"W{i}"] = (dims[i], dims[i + 1])
        out[f"b{i}"] = (dims[i + 1],)
    out["Wl"] = (dims[-1], 1)
    return out


def trainable(cfg: Dict) -> List[str]:
    frozen = () if cfg["emb_trainable"] else ("user_emb", "item_emb")
    return [n for n in leaf_order(len(cfg["hidden_dim"])) if n not in frozen]


def _draw(names: List[str], shp: Dict, copies: int, g: torch.Generator, device) -> List[Tree]:
    """``copies`` trees of the leaves ``names``: one uniform and one normal
    draw for all of them, scaled leaf by leaf."""
    sizes = [math.prod(shp[n]) for n in names]
    n = sum(sizes)
    uni = torch.rand((copies, n), generator=g, device=device) * 2.0 - 1.0
    nor = torch.randn((copies, n), generator=g, device=device)
    trees = []
    for c in range(copies):
        tree, off = {}, 0
        for name, size in zip(names, sizes):
            s = shp[name]
            if name in TABLES:
                x = nor[c, off:off + size] * 1e-4
            elif name.startswith("b"):
                x = torch.zeros(size, device=device)
            elif name == "Wl":
                x = nor[c, off:off + size] * math.sqrt(2.0 / (s[0] + s[1]))
            else:
                x = uni[c, off:off + size] * math.sqrt(6.0 / (s[0] + s[1]))
            tree[name] = x.reshape(s).clone()
            off += size
        trees.append(tree)
    return trees


def make_weights(cfg: Dict, traffic, seed: int, device) -> Tuple[Tree, Tree, List[Tree]]:
    """(frozen tables, shared start, each domain's specific start).

    A trainable table N(0, 1e-4) (deepctr's embedding default), a kernel
    [in, out] glorot-uniform, a bias 0, the logit kernel N(0, 2 / (fan_in +
    fan_out)). ``shared`` holds every trainable leaf; each domain's specific
    start is a fresh draw of the same initialisers (``specific_init``
    "random", the reference's ``init_layer``) or zeros. Frozen tables are
    the traffic's pretrained ones."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    shp, names = shapes(cfg), trainable(cfg)
    shared = _draw(names, shp, 1, g, device)[0]
    if cfg["specific_init"] == "zeros":
        specific = [{n: torch.zeros_like(x) for n, x in shared.items()}
                    for _ in range(cfg["n_domain"])]
    elif cfg["specific_init"] == "random":
        specific = _draw(names, shp, cfg["n_domain"], g, device)
    else:
        raise ValueError(f"unknown specific_init {cfg['specific_init']!r}")
    frozen = {} if cfg["emb_trainable"] else dict(traffic.tables)
    return frozen, shared, specific


@dataclass
class Problem:
    """What both sides are given, on one device."""

    train: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]  # (uid, pid, label) a domain
    frozen: Dict[str, torch.Tensor]          # tables that do not train
    shared0: Dict[str, torch.Tensor]         # every trainable leaf's start
    specific0: List[Dict[str, torch.Tensor]]  # a domain's start, the same leaves
    hidden: Tuple[int, ...]
    dropout: float
    lr: float
    meta_lr: float
    sample_num: int
    add_query: bool
    shuffle_sequence: bool
    reg_step: int
    batch: int
    l2: float
    np_seed: int
    shuffle_seed: int
    dropout_seed: int


def problem(cfg: Dict, inputs) -> Problem:
    """The reference's problem: the configuration's settings and the run's
    inputs (the traffic's train split, the weights and the seeds)."""
    s = inputs.seeds
    return Problem(
        train=inputs.traffic.splits["train"], frozen=inputs.frozen, shared0=inputs.shared0,
        specific0=inputs.specific0, hidden=tuple(cfg["hidden_dim"]), dropout=cfg["dropout"],
        lr=cfg["learning_rate"], meta_lr=cfg["meta_learning_rate"], sample_num=cfg["sample_num"],
        add_query=cfg["add_query_domain"], shuffle_sequence=cfg["shuffle_sequence"],
        reg_step=cfg["domain_regulation_step"], batch=cfg["batch_size"], l2=cfg["l2"],
        np_seed=s["np"], shuffle_seed=s["shuffle"], dropout_seed=s["dropout"])


@dataclass
class Readings:
    """What the comparison reads of a run: each epoch's DN losses (by order
    position), the norm of each trainable leaf's first Adam moment after
    the first epoch, and the norms of the change of each leaf of ``shared``
    and of each domain's specific leaves after the last epoch; and the first
    epoch's first tower calls."""

    losses: List[List[float]] = field(default_factory=list)
    moment: Dict[str, float] = field(default_factory=dict)
    shared_change: Dict[str, float] = field(default_factory=dict)
    specific_change: Dict[str, float] = field(default_factory=dict)  # "d/name"
    # the tower calls of the first epoch: its first two DN steps, and each
    # query domain's first DR step (a dict each: x, label, weight, seeds,
    # dense, loss, dx, grads; the reference's also uid, pid, dom and
    # x_start, the rows from the start's tables)
    calls: Dict[str, List[Dict]] = field(default_factory=lambda: {"dn": [], "dr": []})
    # the lanes of those DR calls: {"rows": {table: ids}, "pre": pieces,
    # "post": pieces}, pieces {"p" | "mu" | "nu": {leaf: tensor}, "count": int}
    lanes: List[Dict] = field(default_factory=list)


class Draws:
    """The epoch's host draws and shuffle keys, from the seeds."""

    def __init__(self, np_seed: int, shuffle_seed: int, device):
        self.rng = np.random.default_rng(np_seed)
        self.gen = torch.Generator(device=device).manual_seed(shuffle_seed)
        self.device = device

    @classmethod
    def from_states(cls, np_state, gen_state, device) -> "Draws":
        """Draws that go on from generators' saved states."""
        d = cls(0, 0, device)
        d.rng.bit_generator.state = np_state
        if gen_state is not None:
            d.gen.set_state(gen_state)
        return d

    def plan(self, n_domain: int, sample_num: int, add_query: bool, shuffle: bool):
        """(order [D], aux [D, K(+1)]): the domain order, then each query
        domain's support domains drawn without replacement from the others."""
        seq = list(range(n_domain))
        if shuffle:
            self.rng.shuffle(seq)
        aux = []
        for q in seq:
            cand = [d for d in seq if d != q]
            row = list(self.rng.choice(cand, size=min(sample_num, len(cand)), replace=False))
            if add_query:
                row.append(q)
            aux.append([int(a) for a in row])
        return [int(q) for q in seq], aux

    def keys(self, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.gen, device=self.device)


def batch_positions(keys: torch.Tensor, n_real: int, n_pad: int, batch: int,
                    steps: int) -> torch.Tensor:
    """[steps, batch] positions in a domain's padded rows (row i is row
    i % n_real, weight 0 from n_real on): real rows first, in the order of
    their keys (ties by position), then the padding."""
    pad = (torch.arange(n_pad, device=keys.device) >= n_real).to(torch.float32) * 2.0
    perm = torch.argsort(keys + pad, stable=True)
    return perm[: steps * batch].reshape(steps, batch)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 explicit mantissa bits, to nearest), gradient
    passed straight through."""
    bits = x.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (r - x.detach())


@contextlib.contextmanager
def _precision(precision: str, device):
    if precision not in ("float32", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    if torch.device(device).type != "cuda":
        yield
        return
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = (
        precision == "tf32")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class _Lane:
    """One tower's training state: flat trainable parameters, Adam's slots
    and count, the step count and the dropout base seed."""

    def __init__(self, p, mu, nu, count: int, step: int, base: int):
        self.p, self.mu, self.nu = p, mu, nu
        self.count, self.step, self.base = count, step, base


class Reference:
    def __init__(self, prob: Problem, precision: str = "float32",
                 fault: Optional[str] = None, slots: str = "float32"):
        if fault not in (None, "half_batch"):
            raise ValueError(f"unknown fault {fault!r}")
        if slots not in ("float32", "bfloat16"):
            raise ValueError(f"unknown slots {slots!r}")
        self.prob, self.precision, self.fault, self.slots = prob, precision, fault, slots
        first = prob.shared0["domain_emb"]
        self.device = first.device
        self.names = [n for n in leaf_order(len(prob.hidden)) if n in prob.shared0]
        self.tower_names = [n for n in self.names if n not in TABLES]
        if set(self.names) & set(prob.frozen):
            raise ValueError("a leaf is both frozen and trainable")
        self.shapes = {n: tuple(prob.shared0[n].shape) for n in self.names}
        sizes = [prob.shared0[n].numel() for n in self.names]
        self.offsets = dict(zip(self.names, np.cumsum([0] + sizes[:-1]).tolist()))
        self.sizes = dict(zip(self.names, sizes))
        b = prob.batch
        self.n_real = [int(u.shape[0]) for u, _, _ in prob.train]
        self.steps = [-(-n // b) for n in self.n_real]
        self.n_pad = max(self.steps) * b
        self.masks = [KeepMasks(b, h, prob.dropout, self.device) for h in prob.hidden]
        self.scale = float(np.float32(1.0 / (1.0 - prob.dropout))) if prob.dropout else 1.0
        self.keep_rows = (torch.arange(b, device=self.device) < b // 2).to(torch.float32)
        self.padded = []  # a domain's columns over its padded rows, and the weights
        for (uid, pid, label), n in zip(prob.train, self.n_real):
            wrap = torch.arange(self.n_pad, device=self.device) % n
            w = (torch.arange(self.n_pad, device=self.device) < n).to(torch.float32)
            self.padded.append((uid[wrap].long(), pid[wrap].long(), label[wrap], w))

    # ---- flat parameter vectors ----

    def pack(self, tree: Dict[str, torch.Tensor]) -> torch.Tensor:
        return torch.cat([tree[n].reshape(-1).to(torch.float32) for n in self.names])

    def leaf(self, flat: torch.Tensor, name: str) -> torch.Tensor:
        o = self.offsets[name]
        return flat[o: o + self.sizes[name]].view(self.shapes[name])

    # ---- one train step ----

    def _matmul(self, a, b):
        if self.precision == "tf32" and self.device.type != "cuda":
            return _tf32(a) @ _tf32(b)
        return a @ b

    def tower_grads(self, x, y, w, seeds: Sequence[int], dense: Sequence[torch.Tensor]):
        """(data loss, dloss/dx, dloss/d dense) of the tower on the field
        rows ``x`` [B, 3D]: dense = (W0, b0, ..., Wl), ``seeds`` a dropout
        seed a layer."""
        drop = [m.many([sd]).to(torch.float32)[0] * self.scale
                for m, sd in zip(self.masks, seeds)] if self.prob.dropout else []
        return self._tower_step(x, y, w, drop, dense)

    def _tower_step(self, x, y, w, drop: Sequence[torch.Tensor], dense):
        """(loss, dx, grads) of the tower, forward and backward written
        out, the dropout as float masks (0 or 1 / (1 - rate)) a layer."""
        n = len(self.prob.hidden)
        mm = self._matmul
        hs, zs, h = [x], [], x
        for i in range(n):
            z = mm(h, dense[2 * i]) + dense[2 * i + 1]
            zs.append(z)
            h = torch.relu(z)
            if drop:
                h = h * drop[i]
            hs.append(h)
        logit = mm(h, dense[-1])[:, 0]
        denom = torch.clamp(torch.sum(w), min=1.0)
        bce = (y * torch.nn.functional.softplus(-logit)
               + (1.0 - y) * torch.nn.functional.softplus(logit))
        loss = torch.sum(bce * w) / denom
        dlogit = ((torch.sigmoid(logit) - y) * w / denom)[:, None]
        grads = [None] * (2 * n) + [mm(h.T, dlogit)]
        dh = mm(dlogit, dense[-1].T)
        for i in range(n - 1, -1, -1):
            if drop:
                dh = dh * drop[i]
            dz = torch.where(zs[i] > 0.0, dh, 0.0)
            grads[2 * i] = mm(hs[i].T, dz)
            grads[2 * i + 1] = torch.sum(dz, dim=0)
            dh = mm(dz, dense[2 * i].T)
        return loss, dh, grads

    def dense(self, p: torch.Tensor) -> List[torch.Tensor]:
        return [self.leaf(p, n) for n in self.tower_names]

    def _fields(self, p, uid, pid, dom: int) -> torch.Tensor:
        prob = self.prob
        tables = {n: prob.frozen[n] if n in prob.frozen else self.leaf(p, n) for n in TABLES}
        dom_row = tables["domain_emb"][dom].expand(uid.shape[0], -1)
        return torch.cat([tables["user_emb"][uid], tables["item_emb"][pid], dom_row], dim=1)

    def _step(self, lane: _Lane, dom: int, pos: torch.Tensor, drop: Sequence[torch.Tensor],
              record: Optional[List[Dict]] = None, lanes: Optional[List[Dict]] = None,
              slots: str = "float32") -> torch.Tensor:
        """One Adam step of ``lane`` on domain ``dom``'s rows at ``pos``
        with the dropout masks ``drop``; returns the batch's data loss (a
        device scalar). With ``record``, appends what the step's tower
        call took and gave; with ``lanes``, the lane's pieces before and
        after the step."""
        prob = self.prob
        uid_p, pid_p, label_p, w_p = self.padded[dom]
        uid, pid, y, w = uid_p[pos], pid_p[pos], label_p[pos], w_p[pos]
        if self.fault == "half_batch":
            w = w * self.keep_rows
        p = lane.p
        x = self._fields(p, uid, pid, dom)
        dense = self.dense(p)
        loss, dx, grads = self._tower_step(x, y, w, drop, dense)
        if record is not None:
            record.append({"x": x, "label": y, "weight": w, "dense": [t.clone() for t in dense],
                           "seeds": step_seeds(lane.base, lane.step, len(prob.hidden)),
                           "loss": loss, "dx": dx, "grads": grads, "uid": uid, "pid": pid,
                           "dom": dom, "x_start": self._fields(self.start, uid, pid, dom)})
        if lanes is not None:
            rows = {"user_emb": uid, "item_emb": pid}
            rows = {n: table_rows(ids, prob.shared0[n].shape[0]) for n, ids in rows.items()
                    if n not in prob.frozen}
            lanes.append({"rows": rows, "pre": self.lane_pieces(lane, rows)})
        g = torch.zeros_like(p)
        for name, t in zip(self.tower_names, grads):
            self.leaf(g, name).copy_(t)
        d = dx.shape[1] // 3
        for f, (name, ids) in enumerate((("user_emb", uid), ("item_emb", pid))):
            if name not in prob.frozen:
                self.leaf(g, name).index_add_(0, ids, dx[:, f * d:(f + 1) * d])
        self.leaf(g, "domain_emb")[dom] += torch.sum(dx[:, 2 * d:], dim=0)
        for name in TABLES:
            if name not in prob.frozen:
                self.leaf(g, name).add_(self.leaf(p, name), alpha=2.0 * prob.l2)
        lane.count += 1
        lane.p, lane.mu, lane.nu = adam(p, lane.mu, lane.nu, g, lane.count, prob.lr, slots)
        lane.step += 1
        if lanes is not None:
            lanes[-1]["post"] = self.lane_pieces(lane, lanes[-1]["rows"])
        return loss

    # ---- one lane's step in pieces (the comparison's) ----

    def lane_pieces(self, lane: _Lane, rows: Dict[str, torch.Tensor]) -> Dict:
        """A lane's parameters and slots by leaf, the tables in ``rows`` as
        those rows, every other leaf whole; and its Adam count."""
        out = {"count": int(lane.count)}
        for key, flat in (("p", lane.p), ("mu", lane.mu), ("nu", lane.nu)):
            out[key] = {n: (self.leaf(flat, n)[rows[n]] if n in rows else self.leaf(flat, n))
                        .clone() for n in self.names}
        return out

    def lane_fields(self, p: Dict[str, torch.Tensor], rows: Dict[str, torch.Tensor],
                    uid: torch.Tensor, pid: torch.Tensor, dom: int) -> Optional[torch.Tensor]:
        """The field rows [B, 3D] of the ids from a lane's pieces ``p``;
        None where an id lies outside the pieces' rows."""
        prob = self.prob
        parts = []
        for name, ids in (("user_emb", uid), ("item_emb", pid)):
            if name in prob.frozen:
                parts.append(prob.frozen[name][ids.long()])
                continue
            at = self._positions(rows[name], ids)
            if at is None:
                return None
            parts.append(p[name][at])
        parts.append(p["domain_emb"][dom].expand(uid.shape[0], -1))
        return torch.cat(parts, dim=1)

    @staticmethod
    def _positions(rows: torch.Tensor, ids: torch.Tensor) -> Optional[torch.Tensor]:
        ids = ids.long().to(rows.device)
        at = torch.searchsorted(rows, ids).clamp(max=rows.shape[0] - 1)
        return at if bool((rows[at] == ids).all()) else None

    def lane_step(self, pre: Dict, rows: Dict[str, torch.Tensor], dx: torch.Tensor,
                  grads: Sequence[torch.Tensor], uid: torch.Tensor, pid: torch.Tensor,
                  dom: int, weight: torch.Tensor) -> Optional[Dict]:
        """The pieces after one DR step of a lane from its pieces ``pre``,
        given the tower's outputs on the step's batch (dx, the dense leaves'
        grads) and the batch's ids and row weights: the gradient of every
        leaf (the field rows' added into the tables, l2 on the tables),
        then Adam in the reference's ``slots``. A batch whose weights are all
        0 is no step. None where an id lies outside the pieces' rows."""
        prob = self.prob
        if float(weight.sum()) == 0.0:
            return pre
        d = dx.shape[1] // 3
        g = dict(zip(self.tower_names, grads))
        for f, (name, ids) in enumerate((("user_emb", uid), ("item_emb", pid))):
            if name in prob.frozen:
                continue
            at = self._positions(rows[name], ids)
            if at is None:
                return None
            g[name] = torch.zeros_like(pre["p"][name]).index_add_(0, at, dx[:, f * d:(f + 1) * d])
        g["domain_emb"] = torch.zeros_like(pre["p"]["domain_emb"])
        g["domain_emb"][dom] += torch.sum(dx[:, 2 * d:], dim=0)
        for name in TABLES:
            if name not in prob.frozen:
                g[name] = g[name] + 2.0 * prob.l2 * pre["p"][name]
        count = pre["count"] + 1
        post = {"count": count, "p": {}, "mu": {}, "nu": {}}
        for n in self.names:
            post["p"][n], post["mu"][n], post["nu"][n] = adam(
                pre["p"][n], pre["mu"][n], pre["nu"][n], g[n].to(pre["p"][n].device), count,
                prob.lr, self.slots)
        return post

    def _run(self, lane: _Lane, dom: int, keys: torch.Tensor, cap: int = 0,
             record: Optional[List[Dict]] = None, n_record: int = 0,
             lanes: Optional[List[Dict]] = None, slots: str = "float32") -> torch.Tensor:
        """An epoch on one domain (at most ``cap`` batches when positive);
        returns its mean data loss. Its first ``n_record`` steps go into
        ``record`` (and ``lanes``); Adam keeps its slots in ``slots``."""
        prob = self.prob
        steps = self.steps[dom] if cap <= 0 else min(cap, self.steps[dom])
        pos = batch_positions(keys, self.n_real[dom], self.n_pad, prob.batch, steps)
        drop = []  # [layer][step] masks of the run, made at once
        if prob.dropout:
            seeds = [step_seeds(lane.base, lane.step + s, len(prob.hidden)) for s in range(steps)]
            drop = [m.many([sd[i] for sd in seeds]).to(torch.float32) * self.scale
                    for i, m in enumerate(self.masks)]
        total = torch.zeros((), device=self.device)
        for s in range(steps):
            kept = s < n_record
            total = total + self._step(lane, dom, pos[s], [m[s] for m in drop],
                                       record if kept else None, lanes if kept else None, slots)
        return total / steps

    # ---- epochs ----

    def run(self, epochs: int) -> Readings:
        with _precision(self.precision, self.device):
            return self._epochs(epochs)

    def _epochs(self, epochs: int) -> Readings:
        prob = self.prob
        draws = Draws(prob.np_seed, prob.shuffle_seed, self.device)
        n_dom = len(prob.train)
        shared = self.pack(prob.shared0)
        shared0 = shared.clone()
        spec = [self.pack(s) for s in prob.specific0]
        spec0 = [s.clone() for s in spec]
        zeros = torch.zeros_like(shared)
        state = _Lane(shared, zeros, zeros, 0, 0, prob.dropout_seed)
        self.start = shared0
        out = Readings()
        for epoch in range(epochs):
            order, aux = draws.plan(n_dom, prob.sample_num, prob.add_query,
                                    prob.shuffle_sequence)
            first = epoch == 0
            # DN; the first epoch's first two steps recorded
            state.p = shared
            losses = []
            for d in order:
                n = 2 - len(out.calls["dn"]) if first else 0
                losses.append(self._run(state, d, draws.keys((self.n_pad,)),
                                        record=out.calls["dn"], n_record=n))
            shared = shared + (state.p - shared) * prob.meta_lr
            out.losses.append(torch.stack(losses).tolist())
            # DR: every query domain from the post-DN state
            keys = [draws.keys((n_dom, self.n_pad)) for _ in range(2 * len(aux[0]))]
            bases = lane_seeds(prob.dropout_seed, n_dom)
            for l, q in enumerate(order):
                lane = _Lane(None, state.mu, state.nu, state.count, state.step, bases[l])
                for j, s in enumerate(aux[l]):
                    merged = shared + spec[q]
                    lane.p = merged
                    self._run(lane, s, keys[2 * j][l], record=out.calls["dr"],
                              n_record=1 if first and j == 0 else 0, lanes=out.lanes,
                              slots=self.slots)
                    self._run(lane, q, keys[2 * j + 1][l], prob.reg_step, slots=self.slots)
                    spec[q] = spec[q] + (lane.p - merged) * prob.meta_lr
            # the next epoch goes on from the last query domain's state,
            # under the run's own dropout base seed
            state = _Lane(lane.p, lane.mu, lane.nu, lane.count, lane.step, prob.dropout_seed)
            if epoch == 0:
                out.moment = self.norms(state.mu)
        out.shared_change = self.norms(shared - shared0)
        for d in range(n_dom):
            for n, v in self.norms(spec[d] - spec0[d]).items():
                out.specific_change[f"{d}/{n}"] = v
        return out

    def norms(self, flat: torch.Tensor) -> Dict[str, float]:
        return {n: float(torch.linalg.vector_norm(self.leaf(flat, n).double())) for n in self.names}
