"""Strategy base class and dispatch (counterpart of ``mamdr_tpu/strategies/base.py``).

A strategy is a host-side schedule over the trainer's phases and evals.
``run()`` is the reference main() flow (run.py:67-89): train with early
stopping, test with the best weights, then, for a ``*_finetune`` model
name, the per-domain finetune stage. Only MAMDR is ported;
``build_strategy`` refuses the others.
"""

from __future__ import annotations

from typing import Dict, Tuple

from mamdr_tpu_torch.train.trainer import Trainer

Result = Tuple[float, float, Dict, Dict]


def _refuse_unported(trainer: Trainer) -> None:
    """Raise for a strategy setting whose path the port does not have yet."""
    tc, spec = trainer.config.train, trainer.config.spec
    if tc.meta_finetune_step > 0:
        raise NotImplementedError(
            f"meta_finetune_step={tc.meta_finetune_step}: the meta-finetune validation "
            "is not ported yet (ROADMAP.md, open items §1: meta_finetune_val)")
    if spec.finetune and not tc.separate_fused:
        raise NotImplementedError(
            "separate_fused=false: the sequential per-domain finetune loop is not "
            "ported yet (ROADMAP.md, open items §1: _separate_loop)")


class Strategy:
    def __init__(self, trainer: Trainer):
        _refuse_unported(trainer)
        self.trainer = trainer
        self.config = trainer.config
        self.spec = trainer.config.spec
        self.tc = trainer.config.train
        self.n_domain = trainer.dataset.n_domain

    def train(self) -> None:
        raise NotImplementedError

    def test(self) -> Result:
        """Test with the best weights (reference base_model.py:121)."""
        t = self.trainer
        best = t.best_params if t.best_params is not None else t.load_checkpoint()
        return t.val_and_test("test", params=best)

    def finetune(self) -> Result:
        """The per-domain finetune from the best weights (run.py:82-85)."""
        from mamdr_tpu_torch.strategies.separate import separate_train_val_test

        t = self.trainer
        t.state = t.state.replace(params=t.load_checkpoint())
        return separate_train_val_test(t, init_params=False)

    def run(self) -> Result:
        """Train, test, and finetune when the model name asks for it."""
        self.train()
        if self.trainer.verbose:
            print("Test Result: ")
        result = self.test()
        if self.spec.finetune:
            if self.trainer.verbose:
                print("Finetune: ")
            result = self.finetune()
        return result


def build_strategy(trainer: Trainer) -> Strategy:
    strategy = trainer.config.spec.strategy
    if strategy == "mamdr":
        from mamdr_tpu_torch.strategies.mamdr import MAMDRStrategy

        return MAMDRStrategy(trainer)
    raise NotImplementedError(
        f"strategy {strategy!r} is not ported yet (ROADMAP.md, open items §1: the rest)")
