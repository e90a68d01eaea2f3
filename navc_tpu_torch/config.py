"""Configuration tree for the PyTorch port (a copy of ``navc_tpu.config``).

The port keeps its own copy so it never imports the JAX package; field names
and defaults are the same, so a checkpoint's settings resolve identically.
``use_pallas`` keeps its name for that reason and here means "run the
hand-written CUDA kernels" (navc_tpu_torch/csrc).

Capability parity with the reference three-tier flag system:
  * argparse defaults            (reference opts.py:5-145)
  * method registry overlay      (reference config/methods.yaml, opts.py:176-183)
  * ``--default`` preset layer   (reference opts.py:161-169, 191-213)
  * NARFormer crit forcing       (reference opts.py:185-189)

The resolved config is a frozen-ish dataclass (mutable for tooling, treated as
immutable once a model is built) that is serialized into every checkpoint so
checkpoints are self-describing (reference misc/run.py:335, train.py:76-79).
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from . import constants as C

# ---------------------------------------------------------------------------
# Method registry (reference config/methods.yaml:1-26)
# ---------------------------------------------------------------------------

METHODS: Dict[str, Dict[str, Any]] = {
    "ARB": {
        "encoder": "Encoder_HighWay",
        "decoder": "BertDecoder",
        "decoding_type": "ARFormer",
        "fusion": "temporal_concat",
        "visual_word_generation": False,
    },
    "ARB2": {
        "encoder": "Encoder_HighWay",
        "decoder": "BertDecoderDisentangled",
        "decoding_type": "ARFormer",
        "fusion": "temporal_concat",
        "visual_word_generation": True,
        "demand": ["VERB", "NOUN"],
    },
    "NAB": {
        "encoder": "Encoder_HighWay",
        "decoder": "BertDecoder",
        "decoding_type": "NARFormer",
        "fusion": "temporal_concat",
        "visual_word_generation": False,
    },
    "NACF": {
        "encoder": "Encoder_HighWay",
        "decoder": "BertDecoderDisentangled",
        "decoding_type": "NARFormer",
        "fusion": "temporal_concat",
        "visual_word_generation": True,
        "demand": ["VERB", "NOUN"],
    },
}

SUPPORTED_DATASETS = ("Youtube2Text", "MSRVTT")


@dataclass
class Config:
    """Fully-resolved run configuration.

    Field defaults mirror the reference argparse defaults (opts.py:5-145).
    """

    # -- top level ----------------------------------------------------------
    dataset: str = "MSRVTT"
    modality: str = "mi"
    default: bool = False
    scope: str = ""
    method: str = ""
    seed: int = 0

    encoder: str = "Encoder_HighWay"
    decoder: str = "BertDecoder"
    decoding_type: str = "ARFormer"  # ARFormer | NARFormer
    fusion: str = "temporal_concat"  # temporal_concat | addition

    # -- model --------------------------------------------------------------
    dim_hidden: int = 512
    num_hidden_layers_decoder: int = 1
    num_attention_heads: int = 8
    intermediate_size: int = 2048
    hidden_act: str = "gelu_new"
    hidden_dropout_prob: float = 0.5
    attention_probs_dropout_prob: float = 0.0
    max_len: int = 30
    layer_norm_eps: float = 1e-5
    watch: int = 0
    pos_attention: bool = False
    enhance_input: int = 2  # 0: none | 1: resampling | 2: mean-pooling
    with_layernorm: bool = False
    use_sigmoid_to_get_attprob: bool = False  # hidden knob, reference bert.py:136
    parallel_mlm: bool = False  # hidden knob, reference bert.py:253-254 + dataloader.py:48
    with_category: bool = False
    num_category: int = 20
    encoder_dropout: float = 0.5
    no_encoder_bn: bool = False
    norm_type: str = "bn"  # bn | ln
    dim_word: int = 512
    tie_weights: bool = False
    vocab_size: int = 0  # filled from the corpus before model construction

    # -- training -----------------------------------------------------------
    learning_rate: float = 5e-4
    decay: float = 0.9
    minimum_learning_rate: float = 5e-5
    n_warmup_steps: int = 0
    optim: str = "adam"  # adam | rmsprop
    grad_clip: float = 5.0
    weight_decay: float = 5e-4
    epochs: int = 50
    batch_size: int = 64
    pretrained_path: str = ""
    teacher_path: str = ""
    beta: List[float] = field(default_factory=lambda: [0.0, 1.0])
    visual_word_generation: bool = False
    demand: List[str] = field(default_factory=lambda: ["VERB", "NOUN"])
    nv_weights: List[float] = field(default_factory=lambda: [0.8, 1.0])
    load_teacher_weights: bool = False
    with_teacher: bool = False
    no_test: bool = False

    # -- evaluation ---------------------------------------------------------
    start_eval_epoch: int = 0
    tolerence: int = 1000
    metric_sum: List[int] = field(default_factory=lambda: [1, 1, 1, 1])
    standard: List[str] = field(default_factory=lambda: ["Bleu_4", "METEOR", "CIDEr"])
    beam_size: int = 1
    beam_alpha: float = 1.0
    topk: int = 1
    paradigm: str = "mp"  # mp | l2r | ef
    length_beam_size: int = 6
    iterations: int = 5
    q: int = 1
    q_iterations: int = 1
    use_ct: bool = False
    length_bias: int = 0
    duplicate: bool = False  # 4-gram dedup of NAR captions (run.py:163-164)
    masking_decision: bool = False
    no_candidate_decision: bool = False
    k_best_model: int = 1
    save_checkpoint_every: int = 1

    # -- multitask ----------------------------------------------------------
    crit: List[str] = field(default_factory=lambda: ["lang"])
    crit_name: List[str] = field(default_factory=lambda: ["Cap Loss"])
    crit_scale: List[float] = field(default_factory=lambda: [1.0])

    # -- dataloader ---------------------------------------------------------
    n_frames: int = 8
    n_total_frames: int = 60
    n_caps_per_video: int = 0
    random_type: str = "segment_random"
    load_feats_type: int = 1
    dim_a: int = 1
    dim_m: int = 2048
    dim_i: int = 2048
    dim_o: int = 1
    dim_t: int = 1
    feats_a_name: List[str] = field(default_factory=list)
    feats_m_name: List[str] = field(
        default_factory=lambda: ["motion_resnext101_kinetics_duration16_overlap8.hdf5"]
    )
    feats_i_name: List[str] = field(
        default_factory=lambda: ["image_resnet101_imagenet_fps_max60.hdf5"]
    )
    feats_o_name: List[str] = field(default_factory=list)
    feats_t_name: List[str] = field(default_factory=list)
    info_corpus_name: str = "info_corpus.pkl"
    reference_name: str = "refs.pkl"

    # -- paths (resolved at runtime) ----------------------------------------
    base_data_path: str = "./data"
    base_checkpoint_path: str = "./experiments"
    checkpoint_path: str = ""
    info_corpus: str = ""
    reference: str = ""
    feats_a: List[str] = field(default_factory=list)
    feats_m: List[str] = field(default_factory=list)
    feats_i: List[str] = field(default_factory=list)
    feats_o: List[str] = field(default_factory=list)
    feats_t: List[str] = field(default_factory=list)

    # -- TPU-native extensions (no reference analogue) ----------------------
    compute_dtype: str = "bfloat16"  # dtype for matmuls on-device
    use_pallas: bool = False  # hand-written CUDA kernels for the decode
    remat: bool = False  # rematerialize the forward in backward (saves HBM)
    mesh_shape: Dict[str, int] = field(default_factory=dict)  # e.g. {"data": 8}
    prefetch_depth: int = 2  # host->device prefetch queue depth

    # ------------------------------------------------------------------
    @property
    def crit_key(self) -> List[tuple]:
        """Per-criterion (prediction key, target key) (reference opts.py:189)."""
        return [C.mapping[item.lower()] for item in self.crit]

    @property
    def modality_dims(self) -> List[int]:
        """Input feature dim per modality char, in modality order."""
        table = {"i": self.dim_i, "m": self.dim_m, "a": self.dim_a,
                 "o": self.dim_o, "t": self.dim_t}
        return [table[ch] for ch in self.modality.lower()]

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


# ---------------------------------------------------------------------------
# Resolution logic
# ---------------------------------------------------------------------------


def check_dataset(cfg: Config) -> Config:
    """Dataset canonicalization + presets (reference opts.py:154-173)."""
    if cfg.dataset.lower() == "msvd":
        cfg = cfg.replace(dataset="Youtube2Text")
    if cfg.dataset not in SUPPORTED_DATASETS:
        raise ValueError(
            "Only Youtube2Text (MSVD) and MSRVTT are supported, got %r" % cfg.dataset
        )
    if cfg.default:
        if cfg.dataset == "Youtube2Text":
            cfg = cfg.replace(beta=[0.0, 1.0], max_len=20, with_category=False)
        elif cfg.dataset == "MSRVTT":
            cfg = cfg.replace(beta=[0.35, 0.9], max_len=30, with_category=True)
    if cfg.dataset == "Youtube2Text" and cfg.with_category:
        raise ValueError("Category information is not available for Youtube2Text")
    return cfg


def check_method(cfg: Config, require_teacher_ckpt: bool = False) -> Config:
    """Method overlay + NAR forcing + default presets (reference opts.py:176-213).

    Args:
        require_teacher_ckpt: when True, assert the resolved teacher checkpoint
            exists (the reference always asserts; tests disable it).
    """
    if cfg.method:
        if cfg.method not in METHODS:
            raise ValueError("Unknown method %r; known: %s" % (cfg.method, list(METHODS)))
        cfg = cfg.replace(**METHODS[cfg.method])

    if cfg.decoding_type == "NARFormer":
        cfg = cfg.replace(
            crit=["lang", "length"],
            crit_name=["Cap Loss", "Length Loss"],
            crit_scale=[1.0, 1.0],
        )

    if cfg.default:
        if cfg.decoding_type == "NARFormer":
            updates: Dict[str, Any] = {}
            if cfg.visual_word_generation:
                updates["use_ct"] = True
                updates["nv_weights"] = [0.8, 1.0]
            updates.update(
                enhance_input=2,
                length_beam_size=6,
                iterations=5,
                beam_alpha=1.35 if cfg.dataset == "MSRVTT" else 1.0,
                teacher_path=os.path.join(
                    cfg.base_checkpoint_path, cfg.dataset, "ARB", cfg.scope, "best.ckpt"
                ),
                load_teacher_weights=True,
                with_teacher=True,
            )
            cfg = cfg.replace(**updates)
            if require_teacher_ckpt and not os.path.exists(cfg.teacher_path):
                raise FileNotFoundError(cfg.teacher_path)
        else:
            cfg = cfg.replace(beam_size=5, beam_alpha=1.0)
    return cfg


def check_valid(cfg: Config) -> None:
    if cfg.load_feats_type not in (0, 1, 2):
        raise ValueError("load_feats_type must be 0, 1 or 2")
    if not cfg.default and not cfg.scope:
        raise ValueError("Please provide a scope (folder name to save models)")


def resolve(cfg: Config, require_teacher_ckpt: bool = False, validate: bool = True) -> Config:
    """Apply the full reference resolution pipeline to a raw Config."""
    cfg = check_dataset(cfg)
    cfg = check_method(cfg, require_teacher_ckpt=require_teacher_ckpt)
    if validate:
        check_valid(cfg)
    return cfg


def default_config(method: str, dataset: str = "MSRVTT", scope: str = "run",
                   require_teacher_ckpt: bool = False, **overrides) -> Config:
    """Convenience: the reference's ``--default --method M --dataset D`` path."""
    cfg = Config(method=method, dataset=dataset, default=True, scope=scope)
    cfg = cfg.replace(**overrides)
    return resolve(cfg, require_teacher_ckpt=require_teacher_ckpt)


def resolve_data_paths(cfg: Config) -> Config:
    """Resolve feature/corpus paths (reference train.py:15-26, 67-70)."""
    root = os.path.join(cfg.base_data_path, cfg.dataset)
    updates: Dict[str, Any] = {}
    for ch in "amiot":
        names = getattr(cfg, "feats_%s_name" % ch)
        updates["feats_%s" % ch] = [os.path.join(root, "feats", n) for n in names if n]
    updates["info_corpus"] = os.path.join(root, cfg.info_corpus_name)
    updates["reference"] = os.path.join(root, cfg.reference_name)
    return cfg.replace(**updates)


def where_to_save_model(cfg: Config) -> str:
    """Checkpoint directory layout (reference train.py:29-35)."""
    return os.path.join(cfg.base_checkpoint_path, cfg.dataset, cfg.method, cfg.scope)
