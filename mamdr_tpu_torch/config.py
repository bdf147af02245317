"""Typed experiment configuration and the model-name micro-DSL.

A copy of the parts of ``mamdr_tpu/config.py`` that the port reads: the
reference JSON schema (``model`` / ``train`` / ``dataset`` blocks) parsed into
dataclasses, and substring dispatch on ``model.name``
(reference: run.py:37-65, README.md:60-159). Unknown keys are ignored, as in
the JAX package, so every config that package reads parses here too.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Union

DEEP_CTR_BASES = ("mlp", "wdl", "nfm", "autoint", "ccpm", "pnn", "deepfm")
MTL_BASES = ("shared_bottom", "mmoe", "ple")
ALL_BASES = ("star",) + DEEP_CTR_BASES + MTL_BASES


@dataclass(frozen=True)
class NameSpec:
    """Parsed form of the model-name micro-DSL.

    ``basemodel[_extension]*`` where extensions are matched by substring
    (reference: run.py:37-65; README.md:62-94). Examples::

        mlp                      -> base=mlp, strategy=joint
        mlp_separate             -> base=mlp, strategy=separate
        mlp_meta_mamdr_finetune  -> base=mlp, strategy=mamdr, finetune=True
        star_meta_domain_negotiation -> base=star, strategy=domain_negotiation
        mlp_meta_batch           -> base=mlp, strategy=maml, batch_update=True
    """

    raw: str
    base: str                 # one of ALL_BASES
    base_family: str          # "deepctr" | "mtl" | "star"
    strategy: str             # joint|separate|maml|reptile|mldg|domain_negotiation|mamdr
    uncertainty_weight: bool
    pcgrad: bool
    finetune: bool            # post-hoc per-domain finetune stage
    batch_update: bool        # defer outer update to end of epoch ("batch")


def parse_model_name(name: str) -> NameSpec:
    """Substring dispatch mirroring reference run.py:37-65."""
    base = None
    # 'star' wins first in the reference dispatch chain (run.py:40).
    if "star" in name:
        base, family = "star", "star"
    else:
        for cand in DEEP_CTR_BASES:
            if cand in name:
                base, family = cand, "deepctr"
                break
        else:
            for cand in MTL_BASES:
                if cand in name:
                    base, family = cand, "mtl"
                    break
            else:
                raise ValueError(f"model name {name!r}: no known base model substring")

    if "separate" in name:
        strategy = "separate"
    elif "meta" in name:
        # reference: run.py:50-61 — order matters (mamdr before reptile etc.)
        if "domain_negotiation" in name:
            strategy = "domain_negotiation"
        elif "mamdr" in name:
            strategy = "mamdr"
        elif "reptile" in name:
            strategy = "reptile"
        elif "mldg" in name:
            strategy = "mldg"
        else:
            strategy = "maml"
    else:
        strategy = "joint"

    return NameSpec(
        raw=name,
        base=base,
        base_family=family,
        strategy=strategy,
        uncertainty_weight="uncertainty_weight" in name,
        pcgrad="pcgrad" in name,
        finetune="finetune" in name,
        batch_update="batch" in name,
    )


@dataclass
class ModelConfig:
    """``model`` block (README.md:100-117)."""

    name: str = "mlp"
    user_dim: int = 128
    item_dim: int = 128
    domain_dim: int = 128
    hidden_dim: List[int] = field(default_factory=lambda: [256, 128, 64])
    dropout: float = 0.0
    # Tower compute dtype. The port computes float32 only; the field is read
    # so that a bfloat16 config is refused rather than silently run in f32.
    compute_dtype: str = "float32"

    @property
    def spec(self) -> NameSpec:
        return parse_model_name(self.name)


@dataclass
class TrainConfig:
    """``train`` block (README.md:118-146): the fields the port reads so far."""

    load_pretrain_emb: bool = False
    emb_trainable: bool = True
    learning_rate: float = 1e-3
    meta_learning_rate: float = 1e-3
    sample_num: int = 5
    add_query_domain: bool = True
    shuffle_sequence: bool = True
    meta_sequence: Union[str, List[int]] = "random"
    target_domain: int = -1
    meta_parms: List[str] = field(default_factory=lambda: ["all"])
    optimizer: str = "adam"
    # MAMDR initial per-domain specific weights: "random" = fresh initializer
    # draws (reference mamdr.py:30-33); "zeros" = zero deltas.
    specific_init: str = "random"
    # Flat-vector Adam over the trainable leaves (train/flat_optimizer.py).
    flat_optimizer: bool = True


@dataclass
class DatasetConfig:
    """``dataset`` block (README.md:147-158)."""

    name: str = "Amazon"                 # Amazon | Taobao | synthetic
    batch_size: int = 1024
    seed: int = 123
    # synthetic-only knobs (used by tests/bench)
    n_domain: int = 3
    n_uid: int = 100
    n_pid: int = 100
    n_per_domain: int = 2048


def _from_dict(cls, d: Dict[str, Any]):
    known = {f.name for f in dataclasses.fields(cls)}
    kwargs = {k: v for k, v in d.items() if k in known}
    return cls(**kwargs)


@dataclass
class ExperimentConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentConfig":
        return cls(
            model=_from_dict(ModelConfig, d.get("model", {})),
            train=_from_dict(TrainConfig, d.get("train", {})),
            dataset=_from_dict(DatasetConfig, d.get("dataset", {})),
        )

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @property
    def spec(self) -> NameSpec:
        return self.model.spec
