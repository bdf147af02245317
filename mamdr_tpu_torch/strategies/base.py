"""Strategy base class and dispatch (counterpart of ``mamdr_tpu/strategies/base.py``).

A strategy is a host-side schedule over the trainer's phases and evals.
``run()`` is the reference main() flow (run.py:67-89): train with early
stopping, test with the best weights (for ``*_separate``: every domain
trained on its own instead), then, for a ``*_finetune`` model name, the
per-domain finetune stage. ``build_strategy`` dispatches joint (with
uncertainty weighting too), separate, PCGrad, MAML, MLDG, Domain
Negotiation, Reptile and MAMDR, on every base model the port builds (the
lanes of separate, finetune and DR take K1-lanes for the plain MLP and the
autograd lane step otherwise), each by its fused passes or by its
per-call loop over ``Trainer.fit_domain``; a setting whose path is not
ported yet is refused, naming its ROADMAP item.
"""

from __future__ import annotations

from typing import Dict, Tuple

from mamdr_tpu_torch.train.trainer import Trainer

Result = Tuple[float, float, Dict, Dict]


class Strategy:
    def __init__(self, trainer: Trainer):
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
        """Train and test (for ``*_separate``: every domain on its own, as
        lanes), then finetune when the model name asks for it."""
        if self.spec.strategy == "separate":
            from mamdr_tpu_torch.strategies.separate import separate_train_val_test

            result = separate_train_val_test(self.trainer, init_params=True)
        else:
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
    """The strategy a model name asks for (JAX ``build_strategy``,
    base.py:64-96)."""
    spec = trainer.config.spec
    if spec.strategy in ("joint", "separate"):
        # PCGrad replaces the joint loop (reference pcgrad.py:16)
        if spec.pcgrad:
            from mamdr_tpu_torch.strategies.pcgrad import PCGradStrategy

            return PCGradStrategy(trainer)
        from mamdr_tpu_torch.strategies.joint import JointStrategy

        return JointStrategy(trainer)
    if spec.strategy == "maml":
        from mamdr_tpu_torch.strategies.maml import MAMLStrategy

        return MAMLStrategy(trainer)
    if spec.strategy == "mldg":
        from mamdr_tpu_torch.strategies.mldg import MLDGStrategy

        return MLDGStrategy(trainer)
    if spec.strategy == "reptile":
        from mamdr_tpu_torch.strategies.reptile import ReptileStrategy

        return ReptileStrategy(trainer)
    if spec.strategy == "domain_negotiation":
        from mamdr_tpu_torch.strategies.domain_negotiation import DomainNegotiationStrategy

        return DomainNegotiationStrategy(trainer)
    if spec.strategy == "mamdr":
        from mamdr_tpu_torch.strategies.mamdr import MAMDRStrategy

        return MAMDRStrategy(trainer)
    raise ValueError(f"unknown strategy {spec.strategy!r}")
