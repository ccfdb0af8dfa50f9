"""Config schema: dataclasses mirroring the reference proto surface.

The PyTorch port's own copy of `singa_tpu/config/schema.py`, kept
identical in behaviour so both packages read a config the same way.

Field names, enum symbols and defaults follow the reference schema
(SINGA's src/proto/model.proto, cluster.proto) so that the
reference's text-format configs (examples/mnist/*.conf) load unchanged.
Enums are kept as their text symbols (e.g. "kSGD", "MAX", "kTrain").

Extra TPU-native fields (mesh axes, precision, modern-parallelism knobs)
are additive and default-off, so reference configs parse with identical
semantics.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from . import textproto

# ---------------------------------------------------------------------------
# enum symbol sets (validation only — values stay strings)

PHASES = ("kTrain", "kValidation", "kTest")
PARTITION_TYPES = ("kDataPartition", "kLayerPartition", "kNone")
CONNECTION_TYPES = ("kOneToOne", "kOneToAll")
INIT_METHODS = (
    "kConstant", "kGaussain", "kUniform", "kPretrained",
    "kGaussainSqrtFanIn", "kUniformSqrtFanIn", "kUniformSqrtFanInOut",
    # TPU-native additions
    "kXavier", "kMSRA",
)
UPDATER_TYPES = ("kAdaGrad", "kAdaDelta", "kNesterov", "kSGD", "kRMSProp",
                 # TPU-native addition
                 "kAdam")
LR_CHANGE_METHODS = ("kFixed", "kInverse_t", "kInverse", "kExponential",
                     "kLinear", "kStep",
                     # TPU-native additions
                     "kCosine", "kWarmupCosine")
GRAD_CALC_ALGS = ("kBackPropagation", "kContrastiveDivergence")
POOL_METHODS = ("MAX", "AVE")
LRN_NORM_REGIONS = ("ACROSS_CHANNELS", "WITHIN_CHANNEL")


class ConfigError(ValueError):
    pass


def _build(cls, raw: Dict[str, List[Any]], path: str):
    """Instantiate dataclass `cls` from a parsed textproto dict."""
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for name, values in raw.items():
        if name not in fields:
            raise ConfigError(f"{path}: unknown field '{name}' for {cls.__name__}")
        f = fields[name]
        ftype = f.metadata.get("msg")
        repeated = f.metadata.get("repeated", False)
        if ftype is not None:
            for v in values:
                if not isinstance(v, dict):
                    raise ConfigError(
                        f"{path}: field '{name}' expects a "
                        f"{ftype.__name__} message block, got scalar {v!r}")
            conv = [_build(ftype, v, f"{path}.{name}") for v in values]
        else:
            conv = values
        if repeated:
            kwargs[name] = conv
        else:
            if len(conv) > 1:
                raise ConfigError(f"{path}: field '{name}' given {len(conv)} times")
            kwargs[name] = conv[0]
    return cls(**kwargs)


def _msg(cls, repeated=False):
    if repeated:
        return field(default_factory=list, metadata={"msg": cls, "repeated": True})
    return field(default=None, metadata={"msg": cls})


def _rep():
    return field(default_factory=list, metadata={"repeated": True})


# ---------------------------------------------------------------------------
# per-layer hyper-parameter messages (model.proto:160-275)


@dataclass
class ConvolutionConfig:
    num_filters: int = 0
    bias_term: bool = True
    pad: int = 0
    stride: int = 1
    kernel: int = 0


@dataclass
class ConcateConfig:
    concate_dimension: int = 0
    concate_num: int = 0


@dataclass
class DataConfig:
    source: str = ""
    path: str = ""
    batchsize: int = 0
    random_skip: int = 0


@dataclass
class DropoutConfig:
    dropout_ratio: float = 0.5


@dataclass
class InnerProductConfig:
    num_output: int = 0
    bias_term: bool = True


@dataclass
class LRNConfig:
    local_size: int = 5
    alpha: float = 1.0
    beta: float = 0.75
    norm_region: str = "ACROSS_CHANNELS"
    knorm: float = 1.0

    def __post_init__(self):
        if self.norm_region not in LRN_NORM_REGIONS:
            raise ConfigError(f"bad norm_region {self.norm_region!r}")


@dataclass
class MnistConfig:
    kernel: int = 0
    sigma: float = 0.0
    alpha: float = 0.0
    beta: float = 0.0
    gamma: float = 0.0
    resize: int = 0
    elastic_freq: int = 0
    norm_a: float = 1.0
    norm_b: float = 0.0


@dataclass
class PoolingConfig:
    pool: str = "MAX"
    kernel: int = 0
    pad: int = 0
    stride: int = 1

    def __post_init__(self):
        if self.pool not in POOL_METHODS:
            raise ConfigError(f"bad pool method {self.pool!r}")


@dataclass
class SliceConfig:
    slice_dimension: int = 0
    slice_num: int = 0


@dataclass
class SplitConfig:
    num_splits: int = 1


@dataclass
class ReLUConfig:
    negative_slope: float = 0.0


@dataclass
class RGBImageConfig:
    scale: float = 1.0
    cropsize: int = 0
    mirror: bool = False
    meanfile: str = ""   # path to mean record (AlexNet-style mean subtract)


@dataclass
class SoftmaxLossConfig:
    topk: int = 1
    scale: float = 1.0


@dataclass
class TanhConfig:
    outer_scale: float = 1.0
    inner_scale: float = 1.0


# --- TPU-native layer configs (modern model families; additive) -----------


@dataclass
class AttentionConfig:
    num_heads: int = 8
    head_dim: int = 64
    causal: bool = True
    # sequence-parallel strategy: "none" | "ring" | "ulysses"
    seq_parallel: str = "none"
    rope: bool = True
    rope_theta: float = 10000.0
    window: int = 0          # sliding-window size, 0 = full
    num_kv_heads: int = 0    # 0 => = num_heads (MHA); else GQA/MQA


@dataclass
class MoEConfig:
    num_experts: int = 8
    experts_per_token: int = 2
    expert_hidden: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01


@dataclass
class EmbedConfig:
    vocab_size: int = 0
    embed_dim: int = 0
    # token-chunk size of the fused kLMHeadLoss layer (0 = default 4096)
    loss_chunk: int = 0


@dataclass
class RMSNormConfig:
    epsilon: float = 1e-6


@dataclass
class RBMConfig:
    num_hidden: int = 0
    cd_k: int = 1
    persistent: bool = False


@dataclass
class FFNConfig:
    hidden_dim: int = 0
    activation: str = "silu"     # silu | gelu | relu
    gated: bool = True           # SwiGLU-style gating


@dataclass
class SequenceDataConfig:
    batchsize: int = 0
    seq_len: int = 0
    vocab_size: int = 0


# ---------------------------------------------------------------------------
# ParamProto (model.proto:54-106)


@dataclass
class ParamConfig:
    name: str = ""
    id: int = -1
    shape: List[int] = _rep()
    split_threshold: int = 5000000
    partition_dim: int = -1
    init_method: str = "kConstant"
    value: float = 1.0
    low: float = -1.0
    high: float = 1.0
    mean: float = 0.0
    std: float = 1.0
    learning_rate_multiplier: float = 1.0
    weight_decay_multiplier: float = 1.0

    def __post_init__(self):
        if self.init_method not in INIT_METHODS:
            raise ConfigError(f"bad init_method {self.init_method!r}")


# ---------------------------------------------------------------------------
# LayerProto (model.proto:124-159)


@dataclass
class LayerConfig:
    name: str = ""
    type: str = ""
    srclayers: List[str] = _rep()
    locationid: int = 0
    partitionid: int = 0
    partition_type: Optional[str] = None
    share_ary: List[str] = _rep()
    param: List[ParamConfig] = _msg(ParamConfig, repeated=True)
    share_param: List[str] = _rep()
    exclude: List[str] = _rep()

    convolution_param: Optional[ConvolutionConfig] = _msg(ConvolutionConfig)
    concate_param: Optional[ConcateConfig] = _msg(ConcateConfig)
    data_param: Optional[DataConfig] = _msg(DataConfig)
    dropout_param: Optional[DropoutConfig] = _msg(DropoutConfig)
    inner_product_param: Optional[InnerProductConfig] = _msg(InnerProductConfig)
    lrn_param: Optional[LRNConfig] = _msg(LRNConfig)
    mnist_param: Optional[MnistConfig] = _msg(MnistConfig)
    pooling_param: Optional[PoolingConfig] = _msg(PoolingConfig)
    slice_param: Optional[SliceConfig] = _msg(SliceConfig)
    split_param: Optional[SplitConfig] = _msg(SplitConfig)
    relu_param: Optional[ReLUConfig] = _msg(ReLUConfig)
    rgbimage_param: Optional[RGBImageConfig] = _msg(RGBImageConfig)
    softmaxloss_param: Optional[SoftmaxLossConfig] = _msg(SoftmaxLossConfig)
    tanh_param: Optional[TanhConfig] = _msg(TanhConfig)
    # TPU-native additions
    attention_param: Optional[AttentionConfig] = _msg(AttentionConfig)
    moe_param: Optional[MoEConfig] = _msg(MoEConfig)
    embed_param: Optional[EmbedConfig] = _msg(EmbedConfig)
    rmsnorm_param: Optional[RMSNormConfig] = _msg(RMSNormConfig)
    rbm_param: Optional[RBMConfig] = _msg(RBMConfig)
    ffn_param: Optional[FFNConfig] = _msg(FFNConfig)
    seqdata_param: Optional[SequenceDataConfig] = _msg(SequenceDataConfig)

    def __post_init__(self):
        for ph in self.exclude:
            if ph not in PHASES:
                raise ConfigError(f"layer {self.name!r}: bad phase {ph!r}")
        if self.partition_type is not None and \
                self.partition_type not in PARTITION_TYPES:
            raise ConfigError(
                f"layer {self.name!r}: bad partition_type {self.partition_type!r}")


# ---------------------------------------------------------------------------
# NetProto / UpdaterProto / ModelProto


@dataclass
class NetConfig:
    layer: List[LayerConfig] = _msg(LayerConfig, repeated=True)
    partition_type: str = "kNone"

    def __post_init__(self):
        if self.partition_type not in PARTITION_TYPES:
            raise ConfigError(f"bad net partition_type {self.partition_type!r}")


@dataclass
class UpdaterConfig:
    type: str = "kAdaGrad"
    hogwild: bool = True
    momentum: float = 0.0
    weight_decay: float = 0.0
    gamma: float = 1.0
    pow: float = 0.0
    delta: float = 1e-7
    rho: float = 0.9
    base_learning_rate: float = 0.0
    final_learning_rate: float = 0.0
    learning_rate_change_frequency: int = 0
    learning_rate_change_method: str = "kFixed"
    sync_frequency: int = 1
    warmup_steps: int = 10
    moving_rate: float = 0.0
    param_type: str = "Elastic"
    # TPU-native additions (Adam betas; kWarmupCosine schedule)
    beta1: float = 0.9
    beta2: float = 0.999

    def __post_init__(self):
        if self.type not in UPDATER_TYPES:
            raise ConfigError(f"bad updater type {self.type!r}")
        if self.learning_rate_change_method not in LR_CHANGE_METHODS:
            raise ConfigError(
                f"bad learning_rate_change_method "
                f"{self.learning_rate_change_method!r}")


@dataclass
class ModelConfig:
    name: str = ""
    train_folder: str = "train"
    test_folder: str = "test"
    validation_folder: str = "validation"
    display_after_steps: int = 0
    display_frequency: int = 0
    validation_after_steps: int = 0
    validation_frequency: int = 0
    test_after_steps: int = 0
    test_frequency: int = 0
    prefetch: bool = True
    train_steps: int = 0
    validation_steps: int = 0
    test_steps: int = 0
    step: int = 0
    updater: Optional[UpdaterConfig] = _msg(UpdaterConfig)
    alg: str = "kBackPropagation"
    neuralnet: Optional[NetConfig] = _msg(NetConfig)
    debug: bool = False
    # TPU-native additions
    precision: str = "float32"        # compute dtype: float32 | bfloat16
    checkpoint_frequency: int = 0
    checkpoint_after_steps: int = 0
    # Raised scoped-VMEM compiler budget for conv-family step programs
    # (see Trainer._compiler_options): "auto" applies it when the net's
    # widest conv has >= 96 filters (the raised budget HANGS LeNet-scale
    # compiles, which is why auto exists), "on" forces it, "off"
    # disables it.  The SINGA_TPU_SCOPED_VMEM env var (same values)
    # overrides this field.
    scoped_vmem: str = "auto"         # auto | on | off

    def __post_init__(self):
        if self.alg not in GRAD_CALC_ALGS:
            raise ConfigError(f"bad alg {self.alg!r}")
        if self.scoped_vmem not in ("auto", "on", "off"):
            raise ConfigError(
                f"scoped_vmem must be auto|on|off, got "
                f"{self.scoped_vmem!r}")


# ---------------------------------------------------------------------------
# ClusterProto (cluster.proto) — plus TPU mesh extensions


@dataclass
class ClusterConfig:
    nworkers: int = 1
    nservers: int = 0
    start_port: int = 6723
    nprocs_per_group: int = 1
    nthreads_per_procs: int = 1
    nthreads_per_server: int = 1
    workspace: str = ""
    vis_subfolder: str = "vis"
    log_subfolder: str = "log"
    synchronous: bool = False
    largest_message: int = 1048576
    bandwidth: float = 100.0
    # --- TPU-native mesh axes (additive). Sizes multiply to the device
    # count; 0/unset axes are dropped. The legacy fields above map onto
    # these when they are left unset (see singa_tpu.parallel.mesh).
    data_parallel: int = 0       # dp axis ("data")
    tensor_parallel: int = 0     # tp axis ("model")
    pipeline_parallel: int = 0   # pp axis ("pipe")
    sequence_parallel: int = 0   # sp/cp axis ("seq")
    expert_parallel: int = 0     # ep axis ("expert")
    # microbatches in flight per pipelined step (GPipe schedule); only
    # meaningful with pipeline_parallel > 1 and layers carrying
    # locationid stage marks.  0 → 2 * pipeline_parallel.
    pipeline_microbatches: int = 0


# ---------------------------------------------------------------------------
# loaders


def load_model_config(path: str) -> ModelConfig:
    return _build(ModelConfig, textproto.parse_file(path), path)


def load_cluster_config(path: str) -> ClusterConfig:
    return _build(ClusterConfig, textproto.parse_file(path), path)


def model_config_from_text(text: str) -> ModelConfig:
    return _build(ModelConfig, textproto.parse(text), "<string>")


def model_config_from_dict(d: Dict[str, Any]) -> ModelConfig:
    """Build from a nested plain dict (values need not be listified)."""
    return _build(ModelConfig, _listify(d), "<dict>")


def config_to_dict(cfg) -> Dict[str, Any]:
    """Dataclass config → nested {field: value} dict, omitting fields that
    still hold their schema default (the loader re-fills them), so the
    emitted text-proto stays as terse as the reference's hand-written
    configs (examples/mnist/*.conf)."""
    out: Dict[str, Any] = {}
    for f in dataclasses.fields(type(cfg)):
        v = getattr(cfg, f.name)
        if f.default is not dataclasses.MISSING and v == f.default:
            continue
        if f.default_factory is not dataclasses.MISSING and v == f.default_factory():  # noqa: E501
            continue
        if dataclasses.is_dataclass(v):
            out[f.name] = config_to_dict(v)
        elif isinstance(v, list):
            out[f.name] = [config_to_dict(x) if dataclasses.is_dataclass(x)
                           else x for x in v]
        else:
            out[f.name] = v
    return out


def model_config_to_text(cfg: "ModelConfig") -> str:
    """Serialize back to the reference's text-proto surface; round-trips
    through load (`model_config_from_text(model_config_to_text(c)) == c`)."""
    return textproto.dump(config_to_dict(cfg)) + "\n"


def _listify(d: Dict[str, Any]) -> Dict[str, List[Any]]:
    out: Dict[str, List[Any]] = {}
    for k, v in d.items():
        vs = v if isinstance(v, list) else [v]
        out[k] = [_listify(x) if isinstance(x, dict) else x for x in vs]
    return out
