"""Configuration tree of the port: its own copy of the groups the ported
slice reads from ``situation3d_tpu/config.py`` (``DataConfig``,
``SparseConfig``, ``ModelConfig``, ``LangConfig``, ``LossConfig``,
``TrainConfig``, ``MeshConfig``, ``QFormerConfig``, ``T5Config``,
``Blip2Config``, ``LogConfig``, ``EvalConfig``, ``Config``) with the same
field names and defaults, so one YAML file or one list of dot-key overrides
configures both packages; an unknown key or group raises, as it does there.

``SparseConfig`` keeps the reference's routing fields (``pallas_gather``,
``fused_conv``, ``conv0_zwin``, ``conv_flat_gather``, ``zwin_level1``, ...)
so the same configuration loads; they chose between formulations on another
accelerator and the port READS AND IGNORES them. The port keeps one
formulation per op: every map-driven conv goes through the fused
gather-GEMM kernel, conv0 runs on its k5 map, and the k3 maps come from the
two map kernels (``sparse/minkunet.py:build_unet_plan`` says which level
goes to which, and how ``dense_lookup`` and ``dense_downsample`` choose
between the dense-grid and the sort-based plan). ``gather_bwd`` is ignored
too: the gather-only conv backward is the only one the port has.
"""
from __future__ import annotations

import ast
import dataclasses
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, List, Optional, Tuple


@dataclass
class DataConfig:
    """SQA3D/ScanQA data pipeline."""
    sqa_train: str = "assets/data/sqa/SQA_train.json"
    sqa_val: str = "assets/data/sqa/SQA_val.json"
    sqa_test: str = "assets/data/sqa/SQA_test.json"
    answer_counter: str = "assets/data/sqa/answer_counter.json"
    scene_dir: str = "assets/data/scannet_3d"
    scans_dir: str = "assets/data/scannet/scans"
    max_text_len: int = 100
    num_answers: int = 706
    answer_min_freq: int = 1
    voxel_size: float = 0.02
    point_capacity: int = 65536        # fixed per-sample padded point budget
    voxel_capacity: int = 49152        # fixed per-sample padded voxel budget
    use_augmentation: bool = True
    aug_rot_z: bool = True
    aug_mirror: bool = False
    num_workers: int = 8
    tokenizer: str = "sentence-transformers/all-mpnet-base-v2"
    seed: int = 42


@dataclass
class SparseConfig:
    """Sparse voxel engine. See sparse/."""
    # MinkUNet18A PLANES
    planes: Tuple[int, ...] = (32, 64, 128, 256, 128, 128, 96, 96)
    layers: Tuple[int, ...] = (2, 2, 2, 2, 2, 2, 2, 2)
    init_dim: int = 32
    in_channels: int = 3
    out_channels: int = 768
    bottleneck_channels: int = 256     # feat_bottleneck consumed by SIG3D
    # fixed per-stride voxel capacities (strides 1, 2, 4, 8, 16)
    capacities: Tuple[int, ...] = (49152, 24576, 12288, 6144, 3072)
    kernel_volume: int = 27
    # dense-grid plan construction over [0, extent) stride-1 voxels
    dense_lookup: bool = True
    grid_extent: Tuple[int, ...] = (512, 512, 256)
    # decoder tail + 768-d head (openscene_out)
    final_result: bool = False
    # k3 maps from the int32-grid kernel / the bit-table kernel; in the port
    # any true value (True or "force") enables the route, and the tensor's
    # device decides between the CUDA kernel and its plain version
    pallas_map: Any = True
    pallas_map_bits: Any = True
    # sort-free downsample (grid occupancy + cumsum) under dense_lookup
    dense_downsample: bool = True
    # --- routing fields of the reference: read and ignored by the port ---
    dense_conv_min_stride: int = 0
    pallas_gather: bool = True
    fused_conv: Any = False
    conv0_zwin: bool = True
    conv0_int8: bool = False
    conv0_flat_gather: bool = True
    conv0_unique_scatter: bool = False
    conv0_flat_scatter: bool = False
    gather_bwd: bool = True
    conv_flat_gather: bool = True
    zwin_level1: Any = False


@dataclass
class ModelConfig:
    """SIG3D model."""
    hidden_size: int = 768
    mcan_flat_mlp_size: int = 256
    mcan_flat_glimpses: int = 1
    mcan_flat_out_size: int = 512
    mcan_dropout: float = 0.1
    mcan_num_heads: int = 8
    mcan_num_layers: int = 2           # 2xSA / 2xSGA
    mcan_ff_size: int = 2048
    num_scene_tokens: int = 256
    scene_feat_dim: int = 256          # bottleneck channels
    lang_model: str = "mpnet"          # "mpnet" | "lstm" (GloVe + LSTM)
    lang_freeze: str = "last_layer"
    situation_loss_tag: str = "__l2__quat__"
    answer_pdrop: float = 0.3
    pos_sigma: float = 0.16            # Gaussian loc-gt sigma
    use_situation: bool = True
    predict_situation: bool = True
    situated_reencode: bool = False    # rotate scene tokens into agent frame
    no_3d: bool = False
    dtype: str = "bfloat16"            # activation dtype


@dataclass
class LangConfig:
    """Language encoder."""
    vocab_size: int = 30527            # mpnet vocab
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 514
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1
    relative_attention_num_buckets: int = 32
    glove_dim: int = 300


@dataclass
class LossConfig:
    """Loss composition."""
    answer_weight: float = 1.0
    aux_situation_weight: float = 1.0
    pos_weight: float = 1.0
    rot_weight: float = 1.0
    vote_weight: float = 0.0           # detection off by default
    objectness_weight: float = 0.0
    box_weight: float = 0.0
    sem_cls_weight: float = 0.0
    amplifier: float = 10.0            # loss *= 10
    answer_loss: str = "bce"           # "bce" (answer_cat_scores) | "ce" (answer_cat)


@dataclass
class TrainConfig:
    """Trainer."""
    batch_size: int = 32
    epochs: int = 40
    lr: float = 2e-5
    weight_decay: float = 0.05
    lr_schedule: str = "step"          # "step" | "multistep" | "warmup_cosine" | "warmup_step"
    lr_decay_steps: Tuple[int, ...] = (15, 20, 25)   # epochs
    lr_decay_rate: float = 0.1
    warmup_steps: int = 1000
    min_lr: float = 1e-5
    grad_clip_value: float = 1.0       # clip by value before AdamW
    grad_accum_steps: int = 1
    bn_momentum_init: float = 0.5
    bn_momentum_decay: float = 0.5
    bn_momentum_step: int = 20
    val_every_steps: int = 1000
    # iteration-based runs of the 3D-LLM trainer (RunnerIter): max_iters > 0
    # bounds the steps, iters_per_inner_epoch > 0 sets the validation and
    # checkpoint cadence; 0 falls back to one epoch
    max_iters: int = 0
    iters_per_inner_epoch: int = 0
    log_every_steps: int = 50
    ckpt_dir: str = "outputs/ckpt"
    ckpt_keep: int = 3
    seed: int = 42
    frozen_prefixes: Tuple[str, ...] = ("scene_encoder",)
    bf16: bool = True                  # bf16 compute, float32 parameters
    donate_state: bool = True          # buffer donation of a jitted step: read and ignored
    # "loss": skip the update when the loss is non-finite; "full": also when
    # any trainable gradient is; "off": no guard
    nan_guard: str = "loss"


@dataclass
class MeshConfig:
    """Data parallelism over processes, one card each (``parallel/mesh.py``).
    ``data_parallel`` is -1 (every process of the run) or the run's process
    count; ``model_parallel`` above 1 (tensor parallelism of T5) is not
    ported. The axis names and ``allow_split_physical_axes`` are the
    reference's, read and kept."""
    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1            # -1 => all processes
    model_parallel: int = 1
    allow_split_physical_axes: bool = True


@dataclass
class QFormerConfig:
    """Q-Former of the 3D-LLM (BLIP-2's querying transformer)."""
    num_query_tokens: int = 32
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    cross_attention_freq: int = 2
    encoder_width: int = 1408          # scene-feature width
    vocab_size: int = 30523            # stage-1 text vocabulary (Blip2Qformer)
    max_position: int = 512
    layer_norm_eps: float = 1e-12
    scene_token_capacity: int = 5120   # scene tokens a sample, padded


@dataclass
class T5Config:
    """FlanT5. Defaults sized for flan-t5-xl."""
    vocab_size: int = 65536            # 32128 + 32768 location tokens, padded
    d_model: int = 2048
    d_kv: int = 64
    d_ff: int = 5120
    num_layers: int = 24
    num_decoder_layers: int = 24
    num_heads: int = 32
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    dense_act_fn: str = "gelu"
    is_gated_act: bool = True
    pad_token_id: int = 0
    eos_token_id: int = 1
    decoder_start_token_id: int = 0
    max_input_len: int = 480           # 32 query + <=400 prompt padded
    max_answer_len: int = 50
    tie_word_embeddings: bool = False
    remat: bool = False                # recompute each block in the backward (training)


@dataclass
class Blip2Config:
    qformer: QFormerConfig = field(default_factory=QFormerConfig)
    t5: T5Config = field(default_factory=T5Config)
    pc_feat_dim: int = 1408
    pos_scale: float = 0.01            # 0.01 x sinusoidal xyz position encoding
    prompt: str = "Question: {} Answer:"
    max_txt_len: int = 400
    freeze_t5_except_embeddings: bool = True


@dataclass
class LogConfig:
    use_wandb: bool = False
    use_tensorboard: bool = False
    project: str = "situation3d_tpu"
    log_dir: str = "outputs/logs"
    profile_steps: Tuple[int, int] = (0, 0)  # (start, stop) profiler window; (0,0)=off


@dataclass
class EvalConfig:
    batch_size: int = 32
    split: str = "val"
    pos_thresholds: Tuple[float, ...] = (0.5, 1.0)     # meters
    rot_thresholds: Tuple[float, ...] = (15.0, 30.0)   # degrees
    num_beams: int = 1                 # beam=1 forced (blip2_t5.py:320)
    max_gen_len: int = 10
    output_dir: str = "outputs/eval"


@dataclass
class Config:
    """Root config (the groups the ported slices read)."""
    data: DataConfig = field(default_factory=DataConfig)
    sparse: SparseConfig = field(default_factory=SparseConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    lang: LangConfig = field(default_factory=LangConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    blip2: Blip2Config = field(default_factory=Blip2Config)
    log: LogConfig = field(default_factory=LogConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)


# ---------------------------------------------------------------------------
# YAML load / dot-key override machinery
# ---------------------------------------------------------------------------

def _coerce(value: Any, target_type: Any) -> Any:
    """Coerce a YAML/CLI value to the annotated field type."""
    if target_type in (int, float, str, bool):
        if target_type is bool and isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return target_type(value)
    origin = getattr(target_type, "__origin__", None)
    if origin in (tuple, Tuple):
        if value is None:  # "key=" means an empty tuple
            return ()
        if isinstance(value, str):
            value = [v for v in value.strip("()[]").split(",") if v.strip()]
        args = getattr(target_type, "__args__", ())
        elem = args[0] if args and args[-1] is Ellipsis else None
        if elem is not None:
            return tuple(_coerce(v, elem) for v in value)
        return tuple(value)
    if origin in (list, List):
        return list(value)
    return value


def _merge_dataclass(cfg: Any, overrides: dict) -> Any:
    """Return a copy of dataclass ``cfg`` with nested dict ``overrides`` applied."""
    kwargs = {}
    by_name = {f.name: f for f in fields(cfg)}
    for key, val in overrides.items():
        if key not in by_name:
            raise KeyError(
                f"Unknown config key {key!r} for {type(cfg).__name__}; "
                f"valid keys: {sorted(by_name)}"
            )
        f = by_name[key]
        cur = getattr(cfg, key)
        if is_dataclass(cur):
            if not isinstance(val, dict):
                raise TypeError(f"Config group {key!r} expects a mapping, got {val!r}")
            kwargs[key] = _merge_dataclass(cur, val)
        else:
            kwargs[key] = _coerce(val, _resolve_type(f))
    return dataclasses.replace(cfg, **kwargs)


def _resolve_type(f) -> Any:
    # field types are strings under `from __future__ import annotations`
    if not isinstance(f.type, str):
        return f.type
    import typing
    ns = {**globals(), **vars(typing)}
    try:
        return eval(f.type, ns)  # noqa: S307 - types defined in this module
    except Exception:
        return str


def _parse_scalar(text: str) -> Any:
    """The subset of YAML scalars an override value uses (booleans, null,
    numbers, bracketed lists), parsed without the ``yaml`` package; anything
    else stays a string for ``_coerce``."""
    s = text.strip()
    low = s.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("", "null", "~"):
        return None
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    if s.startswith("["):
        try:
            return ast.literal_eval(s)
        except (ValueError, SyntaxError):
            pass
    return s


def apply_overrides(cfg: Config, options: List[str]) -> Config:
    """Apply ``a.b.c=value`` dot-key overrides."""
    tree: dict = {}
    for opt in options:
        if "=" not in opt:
            raise ValueError(f"Override must be key=value, got {opt!r}")
        key, val = opt.split("=", 1)
        node = tree
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _parse_scalar(val)
    return _merge_dataclass(cfg, tree)


def load_config(path: Optional[str] = None, options: Optional[List[str]] = None) -> Config:
    """Load a Config from a YAML file (optional) plus dot-key overrides."""
    cfg = Config()
    if path:
        import yaml  # only needed to read a file
        with open(path) as fh:
            data = yaml.safe_load(fh) or {}
        cfg = _merge_dataclass(cfg, data)
    if options:
        cfg = apply_overrides(cfg, options)
    return cfg


def to_dict(cfg: Any) -> Any:
    return dataclasses.asdict(cfg)


def save_config(cfg: Config, path: str) -> None:
    """Write the configuration as JSON (a subset of YAML, so ``load_config``
    reads it back where ``yaml`` is installed)."""
    import json
    with open(path, "w") as fh:
        json.dump(to_dict(cfg), fh, indent=2)
