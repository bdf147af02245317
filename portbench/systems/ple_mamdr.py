"""The system under test: MAMDR epochs of ``mamdr_tpu_torch`` on PLE.

Builds the program's own objects through its normal path (the corpus's
configuration from ``benchmarks.benchmark_config``, a ``MultiDomainDataset``
of the benchmark's traffic, ``Trainer``, ``MAMDRStrategy.prepare_fused``),
hands it the benchmark's inputs (the weights, the specific starts, the
dropout base seed, the shuffle generator and the numpy generator) and runs
``run_fused_epoch``: DN in autograd steps, DR in autograd lane-steps over
groups of query-domain lanes. It reads back only what the comparison judges
and what the metrics count: the epoch's losses and draws, ``shared``, the
specific trees, the optimizer's first moment, and the first epoch's first
two DN steps and each lane of its first DR lane-step, as the reference's
``Readings``.

A step is recorded by wrapping, for the first set-up epoch only, the phase
engine's epoch (``train.fused._epoch_on_flat``) and, around each recorded
step, the model's entries (``apply`` / ``apply_lanes``: the dropout seeds the
step's forward got; ``gather_inputs``: the field rows it gathered and, by a
hook, their gradient) and the optimizer's ``step`` (the gradients it got).
Nothing here reads the program's spans or counters.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.reference.mamdr_mlp import table_rows
from portbench.reference.ple_mamdr import TABLES, Readings
from portbench.systems import mamdr_epoch
from portbench.systems.mamdr_epoch import _numpy


def program_path(name: str) -> str:
    """The program's parameter path of a reference leaf."""
    if name in TABLES:
        return f"embedding/{name}"
    if name.startswith("tower_"):
        return f"towers/{name}"
    return name


class System(mamdr_epoch.System):
    """One trainer and strategy of the program, built once and driven
    epoch after epoch; the MLP system's driving, draws and readings of the
    change norms, over PLE's leaves."""

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
            user_emb=_numpy(tables.get("user_emb")),
            item_emb=_numpy(tables.get("item_emb")),
            seed=seeds["np"], batch_size=cfg["batch_size"], ctr_ratio=dict(enumerate(traffic.ctr)))
        t = Trainer(econf, ds, device=device, verbose=False)
        fixed = {program_path(n): x.clone() for n, x in frozen.items()}
        model = trees.unflatten({**fixed, **{program_path(n): x.clone()
                                             for n, x in shared0.items()}})
        have, want = ({n: tuple(x.shape) for n, x in trees.leaves_with_names(tree)}
                      for tree in (t.state.params["model"], model))
        if have != want:
            raise ValueError(f"the program's leaves {have} are not the benchmark's {want}")
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
        self.dense_names = [n for n in self.names if n not in TABLES]
        self.shared0 = shared0
        self.specific0 = specific0
        self.slot_at = self._slot_offsets()
        self.read = Readings()

    def setup_epoch(self, e: int) -> None:
        """Set-up epoch ``e``; the first records its first steps."""
        if e == 0:
            losses, self.read.calls = self.recorded_epoch()
            self.read.moment = self.moment_norms()
        else:
            losses = self.epoch()
        self.read.losses.append([float(x) for x in losses])

    # ---- the recorded epoch ----

    def recorded_epoch(self):
        """One epoch with its first two DN steps and each lane of its first
        DR lane-step recorded: (losses, {"dn": [...], "dr": [...]})."""
        import mamdr_tpu_torch.train.fused as fused

        steps: Dict[str, List[Dict]] = {"dn": [], "dr": []}
        on_flat = fused._epoch_on_flat

        def rec_flat(train_step, state, flat, *args, **kwargs):
            kind = "dr" if flat["weight"].dim() > 1 else "dn"

            def step(st, batch):
                if len(steps[kind]) >= (2 if kind == "dn" else 1):  # a lane-step: its lanes
                    return train_step(st, batch)
                return self._recorded_step(train_step, st, batch, steps[kind])

            return on_flat(step, state, flat, *args, **kwargs)

        fused._epoch_on_flat = rec_flat
        try:
            losses = self.epoch()
        finally:
            fused._epoch_on_flat = on_flat
        return losses, steps

    def _recorded_step(self, train_step, st, batch, into: List[Dict]):
        """One train step with what it took and gave appended to ``into``,
        a record a lane (one for a DN step)."""
        t = self.trainer
        model, tx = t.model, t.tx
        lanes = batch["uid"].dim() == 2
        seen: Dict[str, object] = {}
        gather_inputs, apply, apply_lanes, opt_step = (
            model.gather_inputs, model.apply, model.apply_lanes, tx.step)

        def rec_gather(*args, **kwargs):
            x, lin = gather_inputs(*args, **kwargs)
            if x.requires_grad and "x" not in seen:
                seen["x"] = x.detach().clone()
                x.register_hook(lambda g: seen.__setitem__("dx", g.detach().clone()))
            return x, lin

        def rec_apply(*args, **kwargs):  # (params, uid, pid, domain, seeds, gather)
            seen.setdefault("seeds", args[4] if len(args) > 4 else kwargs["seeds"])
            return apply(*args, **kwargs)

        def rec_apply_lanes(*args, **kwargs):  # (params, uid, pid, domain, gather, seeds)
            seen.setdefault("seeds", args[5] if len(args) > 5 else kwargs["seeds"])
            return apply_lanes(*args, **kwargs)

        def rec_opt(params, grads, state, has_data):
            seen["grads"] = grads
            return opt_step(params, grads, state, has_data)

        n_lanes = batch["uid"].shape[0] if lanes else 1
        cols = {c: (batch[c] if lanes else batch[c][None]) for c in
                ("uid", "pid", "domain", "label", "weight")}
        rows = [{n: table_rows(cols[c][l], self._leaf(st.params, n).shape[-2])
                 for n, c in (("user_emb", "uid"), ("item_emb", "pid")) if n in self.names}
                for l in range(n_lanes)]
        pre = self._pieces(st, rows, lanes)
        model.gather_inputs, model.apply, model.apply_lanes, tx.step = (
            rec_gather, rec_apply, rec_apply_lanes, rec_opt)
        try:
            out = train_step(st, batch)
        finally:
            del model.gather_inputs, model.apply, model.apply_lanes, tx.step
        post = self._pieces(out[0], rows, lanes)
        seeds = seen["seeds"].reshape(n_lanes, -1)
        loss = out[1].reshape(n_lanes)
        x, dx = (seen[k].reshape(n_lanes, *seen[k].shape[-2:]) for k in ("x", "dx"))
        for l in range(n_lanes):
            grads = {}
            for n in self.dense_names:
                g = self._leaf(seen["grads"], n)
                grads[n] = (g[l] if lanes else g).detach().clone()
            into.append({"uid": cols["uid"][l].long().clone(), "pid": cols["pid"][l].long().clone(),
                         "dom": int(cols["domain"][l][0]), "label": cols["label"][l].clone(),
                         "weight": cols["weight"][l].clone(),
                         "seeds": [int(v) for v in seeds[l].tolist()], "x": x[l], "dx": dx[l],
                         "loss": loss[l].detach().clone(), "grads": grads, "rows": rows[l],
                         "pre": pre[l], "post": post[l]})
        return out

    def _pieces(self, state, rows: List[Dict[str, torch.Tensor]], lanes: bool) -> List[Dict]:
        """Each lane of a state (one for a state without lanes) as the
        comparison's pieces: every trainable leaf's parameters and Adam
        slots (the user and item tables at the lane's ``rows``), and its
        Adam count."""
        opt = state.opt_state
        out = []
        for l, sel in enumerate(rows):
            count = opt.count[l] if lanes else opt.count
            lane = {"count": int(count), "p": {}, "mu": {}, "nu": {}}
            mu, nu = (opt.mu[l], opt.nu[l]) if lanes else (opt.mu, opt.nu)
            for n in self.names:
                off, size, shape = self.slot_at[n]
                p = self._leaf(state.params, n)
                parts = (p[l] if lanes else p, mu[off:off + size].view(shape),
                         nu[off:off + size].view(shape))
                for key, x in zip(("p", "mu", "nu"), parts):
                    lane[key][n] = (x[sel[n]] if n in sel else x).clone()
            out.append(lane)
        return out

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
           "hidden_dim": list(mc.hidden_dim), "tower_hidden_dim": list(mc.tower_hidden_dim),
           "specific_expert_num": mc.specific_expert_num,
           "shared_expert_num": mc.shared_expert_num, "num_levels": mc.num_levels,
           "gate_dnn_hidden_units": list(mc.gate_dnn_hidden_units),
           "user_dim": mc.user_dim, "item_dim": mc.item_dim, "domain_dim": mc.domain_dim,
           "batch_size": dc.batch_size, "optimizer": tc.optimizer,
           "merged_method": tc.merged_method, "meta_parms": list(tc.meta_parms)}
    diff = {k: (v, cfg[k]) for k, v in got.items() if v != cfg[k]}
    if diff:
        raise ValueError(f"the program's configuration differs from the benchmark's: {diff}")
