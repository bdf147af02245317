"""The system under test: MAMDR epochs of ``mamdr_tpu_torch`` on the MLP.

Builds the program's own objects through its normal path (the corpus's
configuration from ``benchmarks.benchmark_config``, a ``MultiDomainDataset``
of the benchmark's traffic, ``Trainer``, ``MAMDRStrategy.prepare_fused``),
hands it the benchmark's inputs (the weights, the specific starts, the
dropout base seed, the shuffle generator and the numpy generator) and runs
``run_fused_epoch``. It reads back only what the comparison judges and what
the metrics count: the epoch's losses and draws, ``shared``, the specific
trees, the optimizer's first moment, and the first epoch's first tower calls
and first DR lane-step, as the reference's ``Readings``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.reference.mamdr_mlp import Readings, table_rows

# The program's parameter paths of the reference's leaves.
_TABLE_PATHS = {"user_emb": "embedding/user_emb", "item_emb": "embedding/item_emb",
                "domain_emb": "embedding/domain_emb", "Wl": "logit/Dense_0/Dense_0/kernel"}


def program_path(name: str) -> str:
    if name in _TABLE_PATHS:
        return _TABLE_PATHS[name]
    kind, i = name[0], int(name[1:])
    return f"dnn/Dense_{i}/Dense_0/" + ("kernel" if kind == "W" else "bias")


class System:
    """One trainer and strategy of the program, built once and driven
    epoch after epoch."""

    def __init__(self, cfg: Dict, inputs, device, workdir: str):
        from mamdr_tpu_torch.benchmarks import benchmark_config
        from mamdr_tpu_torch.data.dataset import DomainSplit, MultiDomainDataset
        from mamdr_tpu_torch.strategies.mamdr import MAMDRStrategy
        from mamdr_tpu_torch.train.trainer import Trainer
        from mamdr_tpu_torch.utils import trees

        self.trees = trees
        traffic, frozen, seeds = inputs.traffic, inputs.frozen, inputs.seeds
        shared0, specific0 = inputs.shared0, inputs.specific0
        econf = benchmark_config(cfg["benchmark"], cfg["model"])
        tc = econf.train
        tc.checkpoint_path = tc.result_save_path = workdir
        tc.metrics_jsonl = False
        _check_settings(cfg, econf)

        def host(split, d):
            uid, pid, label = (c.cpu().numpy() for c in split)
            return DomainSplit.from_arrays(uid, pid, np.full(uid.shape, d), label)

        sp = {k: [host(s, d) for d, s in enumerate(v)] for k, v in traffic.splits.items()}
        tables = traffic.tables or {}
        ds = MultiDomainDataset(
            sp["train"], sp["val"], sp["test"], n_uid=cfg["n_uid"], n_pid=cfg["n_pid"],
            user_emb=_numpy(tables.get("user_emb")), item_emb=_numpy(tables.get("item_emb")),
            seed=seeds["np"], batch_size=cfg["batch_size"], ctr_ratio=dict(enumerate(traffic.ctr)))
        t = Trainer(econf, ds, device=device, verbose=False)
        fixed = {program_path(n): x.clone() for n, x in frozen.items()}
        model = trees.unflatten({**fixed, **{program_path(n): x.clone()
                                             for n, x in shared0.items()}})
        t.state = t.state.replace(params={"model": model}, seed=seeds["dropout"])
        t.gen = torch.Generator(device=t.device).manual_seed(seeds["shuffle"])
        t.np_rng = np.random.default_rng(seeds["np"])
        strat = MAMDRStrategy(t)
        masked = {n[len("model/"):] for n, m in trees.leaves_with_names(strat.mask) if m}
        if masked != {program_path(n) for n in shared0}:
            raise ValueError(f"the program's meta parameters {sorted(masked)} are not the "
                             "benchmark's trainable leaves")
        strat.shared = t.state.params
        strat.specific = [
            {"model": trees.unflatten({**fixed, **{program_path(n): x.clone()
                                                   for n, x in spec.items()}})}
            for spec in specific0]
        strat.prepare_fused()
        self.trainer, self.strat = t, strat
        self.names = list(shared0)
        self.shared0 = shared0
        self.specific0 = specific0
        self.slot_at = self._slot_offsets()
        self.read = Readings()

    def describe(self) -> str:
        """How DR runs: lanes, and in groups of how many (0: all at once)."""
        s = self.strat
        return f"dr_lanes {bool(s.dr_lanes)} group {int(s._dr_lane_chunk_effective)}"

    def group(self) -> Optional[int]:
        """DR's lanes a lane-step: 0 all at once, else the size of a
        group; None where DR runs sequentially, one lane a step."""
        s = self.strat
        return int(s._dr_lane_chunk_effective) if s.dr_lanes else None

    def draw_states(self):
        """The generators' states before an epoch (to replay its draws)."""
        t = self.trainer
        return t.np_rng.bit_generator.state, t.gen.get_state()

    def epoch(self) -> np.ndarray:
        return self.strat.run_fused_epoch()

    def phases(self):
        """The epoch's phases in order, each ended by a sync."""
        return [("dn", self.dn_phase), ("dr", self.dr_phase)]

    def setup_epoch(self, e: int) -> None:
        """Set-up epoch ``e``; the first records its first steps."""
        if e == 0:
            losses, self.read.calls, self.read.lanes = self.recorded_epoch()
            self.read.moment = self.moment_norms()
        else:
            losses = self.epoch()
        self.read.losses.append([float(x) for x in losses])

    def readings(self) -> Readings:
        """What the set-up epochs gave, for the comparison."""
        self.read.shared_change = self.shared_change()
        self.read.specific_change = self.specific_change()
        return self.read

    def recorded_epoch(self):
        """One epoch with its first steps recorded: (losses, calls, lanes).
        ``calls``: the tower kernel's (K1's) first calls, what each took
        and gave, copied: {"dn": the first two one-lane calls, "dr": each
        lane of the first lane call}. ``lanes``: the first DR lane-step's
        lanes, each its state before and after the step in the
        comparison's pieces. The recording wraps the kernel's two entries
        and the phase engine's epoch for this epoch only."""
        import mamdr_tpu_torch.ops.fused_mlp_step as k1
        import mamdr_tpu_torch.train.fused as fused

        calls, lanes = {"dn": [], "dr": []}, []
        one, many, on_flat = k1.fused_tower_grad, k1.fused_tower_grad_lanes, fused._epoch_on_flat
        seen = {"dr": 0}

        def keep(x, label, weight, seeds, dense, out, split):
            loss, dx, grads = out
            rec = dict(x=x, label=label, weight=weight, seeds=seeds, dense=list(dense),
                       loss=loss, dx=dx, grads=list(grads))
            if not split:
                return [_copied(rec)]
            return [_copied({k: (v[l] if not isinstance(v, list) else [t[l] for t in v])
                             for k, v in rec.items()}) for l in range(x.shape[0])]

        def rec_one(x, label, weight, seeds, dense, dims, rate):
            out = one(x, label, weight, seeds, dense, dims, rate)
            if len(calls["dn"]) < 2:
                calls["dn"] += keep(x, label, weight, seeds, dense, out, False)
            return out

        def rec_lanes(x, label, weight, seeds, dense, dims, rate):
            out = many(x, label, weight, seeds, dense, dims, rate)
            if not seen["dr"]:
                seen["dr"] = 1
                calls["dr"] += keep(x, label, weight, seeds, dense, out, True)
            return out

        def rec_flat(train_step, state, flat, *args, **kwargs):
            if lanes or flat["weight"].dim() < 2:  # recorded already, or one lane
                return on_flat(train_step, state, flat, *args, **kwargs)

            def first(st, batch):
                if lanes:
                    return train_step(st, batch)
                rows = [{n: table_rows(batch[c][l], self._leaf(st.params, n).shape[1])
                         for n, c in (("user_emb", "uid"), ("item_emb", "pid"))
                         if n in self.names} for l in range(batch["uid"].shape[0])]
                lanes.extend({"rows": r, "pre": p} for r, p in zip(rows, self._pieces(st, rows)))
                out = train_step(st, batch)
                for lane, post in zip(lanes, self._pieces(out[0], rows)):
                    lane["post"] = post
                return out

            return on_flat(first, state, flat, *args, **kwargs)

        # the entries count their calls on the module's attribute
        rec_one.launches, rec_lanes.launches = one.launches, many.launches
        k1.fused_tower_grad, k1.fused_tower_grad_lanes = rec_one, rec_lanes
        fused._epoch_on_flat = rec_flat
        try:
            losses = self.epoch()
        finally:
            k1.fused_tower_grad, k1.fused_tower_grad_lanes = one, many
            fused._epoch_on_flat = on_flat
            one.launches, many.launches = rec_one.launches, rec_lanes.launches
        return losses, calls, lanes

    def _pieces(self, state, rows: List[Dict[str, torch.Tensor]]) -> List[Dict]:
        """Each lane of a lane-stacked state as the comparison's pieces:
        every trainable leaf's parameters and Adam slots (the user and
        item tables at the lane's ``rows``), and its Adam count."""
        opt = state.opt_state
        out = []
        for l, sel in enumerate(rows):
            lane = {"count": int(opt.count[l]), "p": {}, "mu": {}, "nu": {}}
            for n in self.names:
                off, size, shape = self.slot_at[n]
                parts = (self._leaf(state.params, n)[l], opt.mu[l, off:off + size].view(shape),
                         opt.nu[l, off:off + size].view(shape))
                for key, x in zip(("p", "mu", "nu"), parts):
                    lane[key][n] = (x[sel[n]] if n in sel else x).clone()
            out.append(lane)
        return out

    def dn_phase(self) -> np.ndarray:
        return self.strat.run_dn_phase()

    def dr_phase(self) -> None:
        self.strat.run_dr_phase()
        if self.trainer.device.type == "cuda":
            torch.cuda.synchronize(self.trainer.device)

    # ---- what the comparison reads ----

    def _leaf(self, tree, name):
        node = tree["model"]
        for part in program_path(name).split("/"):
            node = node[part]
        return node

    def _slot_offsets(self) -> Dict[str, tuple]:
        """Each trainable leaf's (offset, size, shape) in the optimizer's
        flat slots, which follow the parameters' leaf order."""
        t = self.trainer
        by_path = {program_path(n): n for n in self.names}
        out, off = {}, 0
        for (path, x), m in zip(self.trees.leaves_with_names(t.state.params),
                                self.trees.leaves(t.tx.mask)):
            if not m:
                continue
            name = by_path.get(path[len("model/"):])
            if name is not None:
                out[name] = (off, x.numel(), tuple(x.shape))
            off += x.numel()
        return out

    def moment_norms(self) -> Dict[str, float]:
        """Each trainable leaf's norm of Adam's first moment, cut from the
        program's flat slot."""
        mu = self.trainer.state.opt_state.mu
        return {n: _norm(mu[off:off + size]) for n, (off, size, _) in self.slot_at.items()}

    def shared_change(self) -> Dict[str, float]:
        return {n: _norm(self._leaf(self.strat.shared, n) - self.shared0[n]) for n in self.names}

    def specific_change(self) -> Dict[str, float]:
        out = {}
        for d, (spec, start) in enumerate(zip(self.strat.specific, self.specific0)):
            for n in self.names:
                out[f"{d}/{n}"] = _norm(self._leaf(spec, n) - start[n])
        return out

    def finite(self) -> bool:
        leaves = [self._leaf(self.strat.shared, n) for n in self.names]
        leaves += [self._leaf(s, n) for s in self.strat.specific for n in self.names]
        return bool(torch.stack([torch.isfinite(x).all() for x in leaves]).all())

    def close(self) -> None:
        self.trainer = self.strat = None


def _copied(rec: Dict) -> Dict:
    out = {k: ([t.detach().clone() for t in v] if isinstance(v, list) else v.detach().clone())
           for k, v in rec.items()}
    out["seeds"] = [int(v) for v in out["seeds"].reshape(-1).tolist()]
    return out


def _numpy(x):
    return None if x is None else x.cpu().numpy()


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def _check_settings(cfg: Dict, econf) -> None:
    """The program's configuration must be the one the benchmark's file
    states (and the reference runs)."""
    tc, mc, dc = econf.train, econf.model, econf.dataset
    got = {"learning_rate": tc.learning_rate, "meta_learning_rate": tc.meta_learning_rate,
           "sample_num": tc.sample_num, "add_query_domain": tc.add_query_domain,
           "shuffle_sequence": tc.shuffle_sequence,
           "domain_regulation_step": tc.domain_regulation_step,
           "specific_init": tc.specific_init, "emb_trainable": tc.emb_trainable,
           "load_pretrain_emb": tc.load_pretrain_emb, "dropout": mc.dropout,
           "hidden_dim": list(mc.hidden_dim), "user_dim": mc.user_dim,
           "item_dim": mc.item_dim, "domain_dim": mc.domain_dim,
           "batch_size": dc.batch_size, "optimizer": tc.optimizer,
           "merged_method": tc.merged_method, "meta_parms": list(tc.meta_parms)}
    diff = {k: (v, cfg[k]) for k, v in got.items() if v != cfg[k]}
    if diff:
        raise ValueError(f"the program's configuration differs from the benchmark's: {diff}")
