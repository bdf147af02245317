"""Typed experiment configuration and the model-name micro-DSL.

A copy of ``mamdr_tpu/config.py`` (every field but one, see ``TrainConfig``):
the reference JSON schema (``model`` / ``train`` / ``dataset`` blocks) parsed into
dataclasses, and substring dispatch on ``model.name``
(reference: run.py:37-65, README.md:60-159). Unknown keys are ignored, as in
the JAX package, so every config that package reads parses here too.
"""

from __future__ import annotations

import dataclasses
import json
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
    """``model`` block (README.md:100-117). Every field of the JAX package's
    is read, so a config of any base model parses, and every base model is
    built (``models/zoo.py`` refuses a compute dtype other than float32)."""

    name: str = "mlp"
    norm: str = "none"            # star only: pn | bn | none
    dense: str = "dense"          # star only: dense | star
    auxiliary_net: bool = False   # star only
    user_dim: int = 128
    item_dim: int = 128
    domain_dim: int = 128
    auxiliary_dim: int = 128
    hidden_dim: List[int] = field(default_factory=lambda: [256, 128, 64])
    dropout: float = 0.0
    # Tower compute dtype: "bfloat16" runs the DNN's and logit head's
    # products of the single-tower models in bf16 (params stay float32); the
    # MTL models and STAR compute in float32 whatever it says.
    compute_dtype: str = "float32"
    # MTL extras (config/Taobao-10/{mmoe,ple}.json)
    tower_hidden_dim: List[int] = field(default_factory=lambda: [64])
    num_experts: int = 4
    gate_dnn_hidden_units: List[int] = field(default_factory=list)
    specific_expert_num: int = 1
    shared_expert_num: int = 1
    num_levels: int = 2
    # AutoInt
    att_head_num: int = 4
    att_layer_num: int = 3
    # CCPM
    conv_kernel_width: List[int] = field(default_factory=lambda: [6, 5])
    conv_filters: List[int] = field(default_factory=lambda: [4, 4])
    # PNN
    use_inner: bool = True
    use_outter: bool = False

    @property
    def spec(self) -> NameSpec:
        return parse_model_name(self.name)


@dataclass
class TrainConfig:
    """``train`` block (README.md:118-146), with the JAX package's fields and
    defaults, so ``config.json.example`` is the same file."""

    load_pretrain_emb: bool = False
    emb_trainable: bool = True
    epoch: int = 99999
    learning_rate: float = 1e-3
    meta_learning_rate: float = 1e-3
    domain_meta_learning_rate: float = 0.1  # read by no strategy (as in the reference)
    merged_method: str = "plus"          # plus | times
    sample_num: int = 5
    add_query_domain: bool = True
    finetune_every_epoch: bool = False
    shuffle_sequence: bool = True
    meta_sequence: Union[str, List[int]] = "random"
    target_domain: int = -1
    # Cap on the query-domain epoch of a DR support run, in steps; 0 = the
    # whole epoch (reference mamdr.py:85-92).
    domain_regulation_step: int = 0
    # Cap on each domain's inner epoch of DN and Reptile, in steps; 0 = the
    # whole epoch (reference reptile.py:56-60).
    meta_train_step: int = 0
    meta_finetune_step: int = 0
    meta_split: str = "train-train"      # MAML / MLDG only
    meta_split_ratio: float = 0.8
    average_meta_grad: str = "none"      # MAML only
    meta_parms: List[str] = field(default_factory=lambda: ["all"])
    # Trainer.save_result writes
    # <result_save_path>/<model>/<dataset>/<split>/loss_X_auc_Y_<time>/.
    result_save_path: str = "result"
    checkpoint_path: str = "checkpoint"
    loss: str = "binary_crossentropy"
    optimizer: str = "adam"
    # Early stop on the validation AUC (reference base_model.py:202-224):
    # validate every `val_every_step` epochs; the finetune stage's per-domain
    # stop needs an improvement of more than `min_delta` (base_model.py:79-82).
    patience: int = 3
    val_every_step: int = 1
    histogram_freq: int = 0
    shuffle_buff_size: int = 10000
    # The per-domain finetune stage: plain SGD at lr 1e-3 in the reference
    # (base_model.py:69, specific_base_model.py:120).
    finetune_optimizer: str = "sgd"
    finetune_learning_rate: float = 1e-3
    reset_optimizer_on_load: bool = False  # read by no strategy (as in the JAX package)
    pcgrad_mode: str = "reference"       # PCGrad only
    # MAMDR initial per-domain specific weights: "random" = fresh initializer
    # draws (reference mamdr.py:30-33); "zeros" = zero deltas.
    specific_init: str = "random"
    min_delta: float = 1e-4
    # resume_every > 0 writes the resume snapshot (state, optimizer slots,
    # batch statistics, dropout seed, torch generators, np_rng, early stop)
    # every N epochs; resume=True goes on from it (Trainer.try_resume).
    resume: bool = False
    resume_every: int = 0
    # checkpoint_dir/metrics.jsonl: one event per evaluation and train epoch.
    metrics_jsonl: bool = True
    # profile_dir != "": each train epoch under torch.profiler with the
    # program's spans on, written to profile_dir/epoch_<n>.trace.json, and
    # its counters logged as an epoch_counters event (utils/trace.py).
    profile_dir: str = ""
    # tensorboard=True writes every evaluation's scalars to
    # checkpoint_dir/tensorboard; histogram_freq > 0 also writes weight
    # histograms every N val epochs and implies tensorboard; write_grads adds
    # the loss gradient's histograms on a sample batch (utils/logging.py).
    tensorboard: bool = False
    write_grads: bool = True
    # On a mesh (Trainer(mesh=), parallel/): a user or item table of at
    # least sharded_lookup_min_rows rows is row-sharded over the table axis,
    # and shard_experts splits MMoE / PLE expert banks over it. Without a
    # mesh they change nothing.
    sharded_lookup_min_rows: int = 16384
    shard_experts: bool = False
    # Each domain's best finetuned weights as checkpoint_dir/domain_{i}.npz.
    domain_checkpoints: bool = True
    # Adam over one flat vector of the trainable leaves; False: leaf by leaf
    # (the same numbers; train/flat_optimizer.py).
    flat_optimizer: bool = True
    # MAMDR's DR phase as query-domain lanes (train/fused.py
    # make_fused_dr_parallel): "auto" takes the lanes when the model is
    # eligible and the lane state fits the card, "on" requires them (and
    # raises with the reason when not eligible), "off" runs the sequential
    # dr_phase.
    dr_parallel: str = "auto"
    # The DR lanes in groups of C, one group after the other, to bound the
    # lane state that exists at once (the same results). 0: all at once, or
    # groups of 7 when a user or item table is trainable and there are more
    # than 7 domains (MAMDRStrategy._lane_chunk).
    dr_lane_chunk: int = 0
    # The finetune / separate lanes (strategies/separate.py); False asks for
    # the sequential per-domain loop (_separate_loop).
    separate_fused: bool = True


@dataclass
class DatasetConfig:
    """``dataset`` block (README.md:147-158)."""

    name: str = "Amazon"                 # Amazon | Taobao | synthetic
    # MultiDomainDataset.from_disk reads <dataset_path>/<domain_split_path>/.
    dataset_path: str = "dataset/Amazon"
    domain_split_path: str = "split_by_category"
    batch_size: int = 1024
    # tf.data knobs of the reference, kept for the config's sake: the port
    # shuffles whole epochs on the device and reads each CSV in one pass.
    shuffle_buffer_size: int = 10000
    num_parallel_reads: int = 8
    seed: int = 123
    # A fixed train order (reference utils/dataset.py:78): from_disk sets
    # the dataset's attribute, which sends every strategy to its per-call
    # loop (Trainer.fused_padding_ok); the synthetic data ignore the key, as
    # the JAX package's do.
    fixed_train: bool = False
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


def load_config(path: str) -> ExperimentConfig:
    """An ExperimentConfig from a JSON file of the reference's schema."""
    with open(path, "r") as f:
        return ExperimentConfig.from_dict(json.load(f))
