"""MLDG: Meta-Learning Domain Generalization.

Counterpart of ``mamdr_tpu/strategies/mldg.py``. Reference
model_zoo/mldg.py:16-366: MAML's scaffolding with another inner loop
(mldg.py:92-119). Per domain:

  1. load meta θ; accumulate the SUPPORT gradients at θ (no inner Adam);
  2. a mid-stream meta-Adam step gives the adapted θ' — it advances the
     meta-Adam's moments and count and does NOT clear the accumulator;
  3. accumulate the QUERY gradients at θ' into the same accumulator
     (acc = g_support(θ) + g_query(θ'));
  4. apply the accumulator with the meta-Adam at meta (per-domain mode:
     now, and clear; ``*_batch``: at the epoch's end).

Net effect: θ <- AdamUpdate(θ, ∇F(θ) + ∇G(θ - α∇F)), the reference's two
meta-Adam moment updates per domain included. Everything else — splits,
refusals, the epoch tail — is MAML's (``fused.make_fused_maml`` with
``mldg``).
"""

from __future__ import annotations

from mamdr_tpu_torch.strategies.maml import MAMLStrategy


class MLDGStrategy(MAMLStrategy):
    _mldg = True
