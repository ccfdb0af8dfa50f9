"""Layer base of the port, the registry, the per-call context, and the
vision layer zoo.

Port of `singa_tpu/core/layers.py` (the base, `:35-116`; the zoo,
`:122-599`; `create_layer`, `:602-613`).  A layer keeps the JAX
package's two duties:

  setup(src_shapes)        shape inference + param spec declaration
  apply(params, srcs, ctx) forward compute on torch tensors

`params` is a plain dict keyed by the JAX names (`conv1/weight`,
`attn0/wq`, ...), so one weights dict fits both packages.  The zoo here
(the reference's registry keys, neuralnet.cc:13-44): kShardData,
kLMDBData, kMnistImage, kRGBImage, kLabel, kConvolution, kPooling, kLRN,
kInnerProduct, kReLU, kTanh, kSigmoid, kDropout, kSoftmaxLoss, kConcate,
kSlice, kSplit, kBridgeSrc, kBridgeDst.  Vision activations are NHWC at
every layer boundary, as in the JAX zoo.  The sequence family lives in
core/seq_layers.py and kRBM in models/rbm.py; `create_layer` imports
each on its first unknown type, and they register on import.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config.schema import LayerConfig, ParamConfig
from ..ops import activations, conv, dropout, linear, lrn, pool
from ..ops.loss import softmax_loss_metrics


class LayerError(ValueError):
    pass


@dataclass
class ParamSpec:
    name: str           # global key: "<layer>/<param-name>"
    shape: Tuple[int, ...]
    fan_in: int
    cfg: ParamConfig
    # ParamProto.partition_dim: the dim a model axis shards (-1: none)
    partition_dim: int = -1
    # the mesh axis that dim shards over; None is the model axis
    # ("model"); kMoE's stacked experts name "expert"
    mesh_axis: Optional[str] = None


_MASK64 = (1 << 64) - 1


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def fold_in(seed: int, *data: int) -> int:
    """A 64-bit generator seed from `seed` and `data`, each folded in by
    one splitmix64 round: the counterpart of chained
    `jax.random.fold_in` (different numbers, the same structure)."""
    h = _splitmix64(int(seed) & _MASK64)
    for d in data:
        h = _splitmix64(h ^ (int(d) & _MASK64))
    return h


@dataclass
class Context:
    """Per-call state threaded through Layer.apply.  `rng` is the seed of
    the call (the trainer's), `step` the global step and `layer_index`
    the layer's place in the topological order; `device` is the params'
    device.  `generators` (layer index → generator) are the caller's
    own, already seeded for this step (the trainer's, which a CUDA graph
    replays).  `shard` is (index, n) when the batch is one of n equal
    slices of a global batch (data parallelism): a layer that draws over
    the batch draws the global batch's numbers and keeps its slice
    (`global_rows`).  `tp` (a `parallel.partition.ModelShards`) is set
    when the params are this rank's shards over a model axis: a layer
    that partitions its compute reads its shards and that axis's group
    from it, and `full` gathers a param whole.  `seq` (a
    `parallel.comm.AxisGroup`) is set when the batch is this rank's
    chunk of dim 1 (sequence parallelism): a drawing layer keeps its
    columns of the global draw (`global_cols`) and kAttention runs over
    the group.  `tokens` (an `ops.moe.TokenSplit`) is set when the
    batch's tokens are one block of a global batch split over several
    ranks, and `experts` (an `AxisGroup`) when the params hold this
    rank's experts of an expert axis: kMoE routes the global tokens and
    runs its own experts."""
    batch: Dict[str, Any]
    train: bool
    compute_dtype: Optional[torch.dtype] = None
    rng: Optional[int] = None
    layer_index: int = 0
    step: Optional[int] = None
    device: Optional[torch.device] = None
    generators: Optional[Dict[int, torch.Generator]] = None
    shard: Optional[Tuple[int, int]] = None
    tp: Any = None
    seq: Any = None
    tokens: Any = None
    experts: Any = None

    def global_cols(self, s: int) -> Tuple[int, int]:
        """(columns to draw, first column of this chunk) for a local
        dim 1 of `s`: (s, 0) unless the batch is a seq chunk."""
        if self.seq is None:
            return s, 0
        return s * self.seq.n, self.seq.index * s

    def shard_dim(self, key: str) -> Optional[int]:
        """The dim of param `key` that this rank holds a shard of, or
        None for a whole param."""
        return None if self.tp is None else self.tp.dims.get(key)

    def full(self, params: Dict[str, torch.Tensor], key: str
             ) -> torch.Tensor:
        """Param `key` whole (gathered over the model axis and unpadded
        where this rank holds a shard); its gradient reaches the shard."""
        if self.shard_dim(key) is None:
            return params[key]
        return self.tp.full(params, key)

    def global_rows(self, b: int) -> Tuple[int, int]:
        """(rows to draw, first row of this slice) for a local batch of
        `b` rows: (b, 0) unless the batch is a slice."""
        if self.shard is None:
            return b, 0
        index, n = self.shard
        return b * n, index * b

    def layer_rng(self) -> torch.Generator:
        """This layer's generator at this step, seeded from (rng, step,
        layer index) — `fold_in(fold_in(rng, step), layer_index)` in the
        JAX package (`:64-67`, `core/trainer.py:396`) — so a resumed run
        draws what an uninterrupted one draws without stored state.  The
        caller's generator when `generators` holds one (seeded by the
        caller with `layer_seed`), else a new one seeded here."""
        if self.generators and self.layer_index in self.generators:
            return self.generators[self.layer_index]
        if self.rng is None:
            raise LayerError("layer needs an rng but none was provided")
        gen = torch.Generator(device=self.device or "cpu")
        gen.manual_seed(layer_seed(self.rng, self.step, self.layer_index))
        return gen


def layer_seed(rng: int, step: Optional[int], layer_index: int) -> int:
    """The seed of a drawing layer's generator at `step`."""
    return fold_in(rng, step or 0, layer_index)


LAYER_REGISTRY: Dict[str, type] = {}


def register_layer(type_name: str):
    def deco(cls):
        LAYER_REGISTRY[type_name] = cls
        cls.type_name = type_name
        return cls
    return deco


class Layer:
    """Base layer. Subclasses fill out_shape and param_specs in setup()."""

    is_data = False     # True → reads from ctx.batch, has no srcs
    is_loss = False     # True → apply returns a metrics dict incl. "loss"
    draws = False       # True → training draws from `Context.layer_rng`

    def __init__(self, cfg: LayerConfig):
        self.cfg = cfg
        self.name = cfg.name
        self.out_shape: Any = None
        self.param_specs: List[ParamSpec] = []

    def setup(self, src_shapes: List[Any]) -> None:
        raise NotImplementedError

    def apply(self, params: Dict[str, torch.Tensor], srcs: List[Any],
              ctx: Context) -> Any:
        raise NotImplementedError

    def step_variant(self, step: int) -> Any:
        """What this layer's training forward decides on the host from
        the step number (None: nothing).  A captured step keys its graphs
        by it, so no graph bakes in another step's decision."""
        return None

    def _param_cfg(self, i: int, default_name: str) -> ParamConfig:
        if i < len(self.cfg.param):
            return self.cfg.param[i]
        return ParamConfig(name=default_name)

    # True where `apply` partitions its own compute over a model axis
    # (it reads `ctx.tp`); every other layer is handed its params whole
    tp_aware = False

    def _declare(self, i: int, default_name: str, shape,
                 fan_in: int, partition_dim: int = -1) -> str:
        pcfg = self._param_cfg(i, default_name)
        key = f"{self.name}/{pcfg.name or default_name}"
        if pcfg.partition_dim != -1:      # the config's dim wins
            partition_dim = pcfg.partition_dim
        self.param_specs.append(ParamSpec(key, tuple(shape), fan_in, pcfg,
                                          partition_dim))
        return key


def _cast(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    return x if dtype is None else x.to(dtype)


# ---------------------------------------------------------------------------
# data / parser layers


@register_layer("kShardData")
class ShardDataLayer(Layer):
    """Input layer (layer.cc:646-673): the record batch the host supplies
    in ctx.batch[self.name]."""

    is_data = True

    def setup(self, src_shapes, sample_shapes: Optional[Dict] = None):
        bs = self.cfg.data_param.batchsize if self.cfg.data_param else 0
        self.batchsize = bs
        self.sample_shapes = sample_shapes or {}
        self.out_shape = {k: (bs,) + tuple(v)
                          for k, v in self.sample_shapes.items()}

    def apply(self, params, srcs, ctx):
        try:
            return ctx.batch[self.name]
        except KeyError:
            raise LayerError(
                f"batch missing entry for data layer {self.name!r}; "
                f"have {list(ctx.batch)}") from None


@register_layer("kLMDBData")
class LMDBDataLayer(ShardDataLayer):
    """LMDB-backed data layer (layer.cc:237-328); on the device it is
    ShardData: the host pipeline supplies the batch."""


@register_layer("kMnistImage")
class MnistImageLayer(Layer):
    """Parser (layer.cc:380-473): uint8 pixels → x/norm_a − norm_b, output
    (B, s, s); `resize` rescales bilinearly (with antialiasing, as
    `jax.image.resize`).  In training, when any strength of MnistProto's
    elastic distortion (kernel, sigma, alpha, beta, gamma) is set, the
    resized images are deformed (`ops/augment.py`) before the scaling;
    `elastic_freq > 1` distorts only every elastic_freq-th step
    (layer.cc:462), decided on the host from the step (`step_variant`),
    so a captured step keeps one graph for distorting steps and one for
    the others, where the JAX package branches with `lax.cond`."""

    def setup(self, src_shapes):
        p = self.cfg.mnist_param
        self.norm_a = p.norm_a if p else 1.0
        self.norm_b = p.norm_b if p else 0.0
        self.distort = dict(
            kernel=p.kernel, sigma=p.sigma, alpha=p.alpha,
            beta=p.beta, gamma=p.gamma) if p else {}
        self.distort_on = bool(p and (
            (p.alpha > 0 and p.kernel > 0) or p.beta > 0 or p.gamma > 0))
        self.draws = self.distort_on
        self.elastic_freq = p.elastic_freq if p else 0
        self.resize = p.resize if p else 0
        pix = tuple(src_shapes[0]["pixel"])
        if self.resize:
            pix = pix[:1] + (self.resize, self.resize) + pix[3:]
        self.out_shape = pix

    def step_variant(self, step):
        if self.distort_on and self.elastic_freq > 1:
            return step % self.elastic_freq == 0
        return None

    def apply(self, params, srcs, ctx):
        x = srcs[0]["pixel"].float()
        if self.resize and tuple(x.shape[1:3]) != (self.resize,) * 2:
            x = _resize_bilinear(x, self.resize)
        if (self.distort_on and ctx.train
                and (ctx.step is None or self.step_variant(ctx.step)
                     is not False)):
            from ..ops.augment import elastic_deform
            x = elastic_deform(x, ctx.layer_rng(),
                               rows=ctx.global_rows(x.shape[0]),
                               **self.distort)
        x = x / self.norm_a - self.norm_b
        return _cast(x, ctx.compute_dtype)


def _resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """(B, H, W[, C]) → (B, size, size[, C]), `jax.image.resize`'s
    antialiased bilinear."""
    t = x.unsqueeze(1) if x.dim() == 3 else x.permute(0, 3, 1, 2)
    t = F.interpolate(t, size=(size, size), mode="bilinear",
                      antialias=True, align_corners=False)
    return t[:, 0] if x.dim() == 3 else t.permute(0, 2, 3, 1)


@register_layer("kRGBImage")
class RGBImageLayer(Layer):
    """Parser (layer.cc:571-643): mean-subtract, random crop and mirror in
    training, center crop in eval, scale.  Host batches arrive
    channels-first (B, 3, H, W); the parser transposes once to NHWC.
    Crop offsets and mirror coins are drawn per image from the layer's
    generator, as the reference draws them per record; mirroring is
    train-only (the JAX package's two deviations, `:265-275`).  The mean
    is the batch's `mean` field, else the configured `meanfile` (a mean
    record, read once at setup and kept on the device after its first
    use)."""

    def setup(self, src_shapes):
        p = self.cfg.rgbimage_param
        self.scale = p.scale if p else 1.0
        self.cropsize = p.cropsize if p else 0
        self.mirror = bool(p.mirror) if p else False
        self.mean = (self._load_mean(p.meanfile)
                     if p and p.meanfile else None)
        self._mean_on: Dict[torch.device, torch.Tensor] = {}
        b, c, h, w = src_shapes[0]["pixel"]   # (B, C, H, W) host layout
        cs = self.cropsize
        self.draws = self.mirror or bool(cs and (h > cs or w > cs))
        if self.cropsize:
            h = w = self.cropsize
        self.out_shape = (b, h, w, c)

    @staticmethod
    def _load_mean(path: str) -> np.ndarray:
        """The per-pixel mean record (the mean.binaryproto role,
        layer.cc:579-583), as `singa_tpu/core/layers.py:227-252` reads
        it: a `Record` whose image holds the mean in `data`.  A missing
        or malformed file raises, naming it."""
        from ..data.records import Record
        try:
            with open(path, "rb") as f:
                rec = Record.decode(f.read())
            return np.asarray(rec.image.data, np.float32).reshape(
                tuple(rec.image.shape))
        except FileNotFoundError:
            raise LayerError(
                f"rgbimage_param.meanfile {path!r} does not exist — write "
                f"the mean as a Record (data/records.py) whose image "
                f"holds it in `data`") from None
        except Exception as e:  # noqa: BLE001 — any decode failure
            raise LayerError(
                f"rgbimage_param.meanfile {path!r} is not a mean "
                f"record: {type(e).__name__}: {e}") from e

    def _file_mean(self, device: torch.device) -> Optional[torch.Tensor]:
        """The meanfile's mean on `device`, copied there once."""
        if self.mean is None:
            return None
        t = self._mean_on.get(device)
        if t is None:
            t = self._mean_on[device] = torch.from_numpy(self.mean).to(device)
        return t

    def apply(self, params, srcs, ctx):
        x = srcs[0]["pixel"].float()
        # a batch's mean (the pipeline's) wins over the configured file
        mean = srcs[0].get("mean")
        if mean is None:
            mean = self._file_mean(x.device)
        if mean is not None:
            x = x - mean
        x = x.permute(0, 2, 3, 1)   # → NHWC
        b, h, w, c = x.shape
        cs = self.cropsize
        crop = bool(cs and (h > cs or w > cs))
        gen = (ctx.layer_rng() if ctx.train and (self.mirror or crop)
               else None)
        # the draws of the global batch, this slice's rows of them
        gb, lo = ctx.global_rows(b)
        if crop:
            if ctx.train:
                oh = torch.randint(0, max(h - cs, 1), (gb,), generator=gen,
                                   device=x.device)[lo:lo + b]
                ow = torch.randint(0, max(w - cs, 1), (gb,), generator=gen,
                                   device=x.device)[lo:lo + b]
                ar = torch.arange(cs, device=x.device)
                rows = (oh[:, None] + ar)[:, :, None]
                cols = (ow[:, None] + ar)[:, None, :]
                x = x[torch.arange(b, device=x.device)[:, None, None],
                      rows, cols]
            else:
                oh, ow = (h - cs) // 2, (w - cs) // 2
                x = x[:, oh:oh + cs, ow:ow + cs]
        if self.mirror and ctx.train:
            flip = torch.rand((gb,), generator=gen,
                              device=x.device)[lo:lo + b] < 0.5
            x = torch.where(flip[:, None, None, None], x.flip(2), x)
        x = x * self.scale
        return _cast(x.contiguous(), ctx.compute_dtype)


@register_layer("kLabel")
class LabelLayer(Layer):
    """Parser (layer.cc:416-432): int labels, shape (B,)."""

    def setup(self, src_shapes):
        self.out_shape = tuple(src_shapes[0]["label"])

    def apply(self, params, srcs, ctx):
        return srcs[0]["label"]


# ---------------------------------------------------------------------------
# neuron layers


def _nhwc_shape(shape):
    """Conv and pool take 3-D (B, H, W) inputs as one channel
    (layer.cc:31-36) → (B, H, W, 1)."""
    if len(shape) == 3:
        return (shape[0], shape[1], shape[2], 1)
    return tuple(shape)


def _as_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.unsqueeze(-1) if x.dim() == 3 else x


@register_layer("kConvolution")
class ConvolutionLayer(Layer):
    """layer.cc:26-123.  Weight in the reference layout (num_filters,
    C·k·k); compute is one `F.conv2d` (ops/conv.py).  Weight and bias
    shard their filters (dim 0) over a model axis: each rank convolves
    with its filters and the output channels are gathered."""

    tp_aware = True

    def setup(self, src_shapes):
        p = self.cfg.convolution_param
        if p is None or not p.kernel:
            raise LayerError(f"{self.name}: convolution_param.kernel required")
        b, h, w, c = _nhwc_shape(src_shapes[0])
        self.channels = c
        self.kernel, self.stride, self.pad = p.kernel, p.stride, p.pad
        self.bias_term = p.bias_term
        self.out_shape = (b, conv.conv_out_size(h, p.kernel, p.stride, p.pad),
                          conv.conv_out_size(w, p.kernel, p.stride, p.pad),
                          p.num_filters)
        col_height = c * p.kernel * p.kernel
        self.num_filters = p.num_filters
        self.w_key = self._declare(0, "weight", (p.num_filters, col_height),
                                   fan_in=col_height, partition_dim=0)
        if self.bias_term:
            self.b_key = self._declare(1, "bias", (p.num_filters,), fan_in=0,
                                       partition_dim=0)

    def apply(self, params, srcs, ctx):
        keys = [self.w_key] + ([self.b_key] if self.bias_term else [])
        return _column_parallel(
            ctx, params, keys, 0, _as_nhwc(srcs[0]), self.num_filters,
            lambda x, w, b: conv.conv2d(
                x, w, b, kernel=self.kernel, stride=self.stride,
                pad=self.pad, channels=self.channels))


def _column_parallel(ctx, params, keys, w_dim: int, x, width: int, fn):
    """`fn(x, weight, bias)` with its output features (the last dim)
    split over the model axis where the weight holds dim `w_dim` and the
    bias dim 0 as shards: each rank computes its (padded) share from the
    replicated input and the shares are gathered and unpadded to
    `width`.  Else on the params whole."""
    if ctx.tp is not None and [ctx.shard_dim(k) for k in keys] == \
            [w_dim] + [0] * (len(keys) - 1):
        from ..parallel import comm
        g = ctx.tp.group
        bias = params[keys[1]] if len(keys) > 1 else None
        y = fn(comm.copy_to(x, g), params[keys[0]], bias)
        return comm.all_gather(y, -1, g)[..., :width]
    bias = ctx.full(params, keys[1]) if len(keys) > 1 else None
    return fn(x, ctx.full(params, keys[0]), bias)


@register_layer("kPooling")
class PoolingLayer(Layer):
    def setup(self, src_shapes):
        p = self.cfg.pooling_param
        if p is None or not p.kernel:
            raise LayerError(f"{self.name}: pooling_param.kernel required")
        b, h, w, c = _nhwc_shape(src_shapes[0])
        self.kernel, self.stride, self.mode = p.kernel, p.stride, p.pool
        self.out_shape = (b, pool.pooled_size(h, p.kernel, p.stride),
                          pool.pooled_size(w, p.kernel, p.stride), c)

    def apply(self, params, srcs, ctx):
        x = _as_nhwc(srcs[0])
        if self.mode == "MAX":
            return pool.max_pool2d(x, self.kernel, self.stride)
        return pool.avg_pool2d(x, self.kernel, self.stride)


@register_layer("kLRN")
class LRNLayer(Layer):
    """Cross-channel LRN through K5/K6 (ops/lrn.py).  `fuse_from`: set by
    NeuralNet when this LRN's source is a plain ReLU of one source —
    apply() then receives the pre-relu tensor and the ReLU runs inside
    the kernels (the ReLU layer still produces its output for any other
    consumer)."""

    fuse_from: str = ""

    def setup(self, src_shapes):
        p = self.cfg.lrn_param
        self.local_size = p.local_size if p else 5
        if self.local_size % 2 != 1:
            raise LayerError(f"{self.name}: LRN local_size must be odd")
        self.alpha = p.alpha if p else 1.0
        self.beta = p.beta if p else 0.75
        self.knorm = p.knorm if p else 1.0
        self.out_shape = tuple(src_shapes[0])

    def apply(self, params, srcs, ctx):
        return lrn.relu_lrn(srcs[0], self.local_size, self.alpha, self.beta,
                            self.knorm, relu=bool(self.fuse_from))


@register_layer("kInnerProduct")
class InnerProductLayer(Layer):
    """layer.cc:162-213: flatten to (B, vdim), weight (vdim, hdim).  The
    reference passes fan_in = vdim·hdim to Param::Setup (layer.cc:174),
    kept for init parity.  vdim's element order is the NHWC activation's
    (H, W, C), as in the JAX package, so an fc weight carries across
    unchanged.  The weight shards its outputs (dim 1) and the bias its
    only dim over a model axis: each rank computes its features and
    they are gathered."""

    tp_aware = True

    def setup(self, src_shapes):
        p = self.cfg.inner_product_param
        if p is None or not p.num_output:
            raise LayerError(f"{self.name}: inner_product_param.num_output "
                             "required")
        s = tuple(src_shapes[0])
        vdim, hdim = int(math.prod(s[1:])), p.num_output
        self.bias_term = p.bias_term
        self.out_shape = (s[0], hdim)
        self.hdim = hdim
        self.w_key = self._declare(0, "weight", (vdim, hdim),
                                   fan_in=vdim * hdim, partition_dim=1)
        if self.bias_term:
            self.b_key = self._declare(1, "bias", (hdim,), fan_in=0,
                                       partition_dim=0)

    def apply(self, params, srcs, ctx):
        keys = [self.w_key] + ([self.b_key] if self.bias_term else [])
        return _column_parallel(ctx, params, keys, 1, srcs[0], self.hdim,
                                linear.linear)


@register_layer("kReLU")
class ReLULayer(Layer):
    def setup(self, src_shapes):
        self.slope = (self.cfg.relu_param.negative_slope
                      if self.cfg.relu_param else 0.0)
        self.out_shape = tuple(src_shapes[0])

    def apply(self, params, srcs, ctx):
        return activations.relu(srcs[0], self.slope)


@register_layer("kTanh")
class TanhLayer(Layer):
    """The reference's kTanh is the scaled tanh stanh (layer.cc:688-701);
    TanhProto outer/inner_scale override its constants."""

    def setup(self, src_shapes):
        p = self.cfg.tanh_param
        if p is not None:
            self.outer, self.inner = p.outer_scale, p.inner_scale
        else:
            self.outer = activations.STANH_OUTER
            self.inner = activations.STANH_INNER
        self.out_shape = tuple(src_shapes[0])

    def apply(self, params, srcs, ctx):
        return activations.stanh(srcs[0], self.outer, self.inner)


@register_layer("kSigmoid")
class SigmoidLayer(Layer):
    def setup(self, src_shapes):
        self.out_shape = tuple(src_shapes[0])

    def apply(self, params, srcs, ctx):
        return activations.sigmoid(srcs[0])


@register_layer("kDropout")
class DropoutLayer(Layer):
    def setup(self, src_shapes):
        self.rate = (self.cfg.dropout_param.dropout_ratio
                     if self.cfg.dropout_param else 0.5)
        self.draws = self.rate > 0.0
        self.out_shape = tuple(src_shapes[0])

    def apply(self, params, srcs, ctx):
        if not ctx.train or self.rate <= 0.0:
            return srcs[0]
        x = srcs[0]
        return dropout.dropout(x, self.rate, ctx.layer_rng(),
                               rows=ctx.global_rows(x.shape[0]),
                               cols=(ctx.global_cols(x.shape[1])
                                     if x.dim() > 1 else None))


# ---------------------------------------------------------------------------
# loss layers


@register_layer("kSoftmaxLoss")
class SoftmaxLossLayer(Layer):
    """layer.cc:702-765: softmax + NLL + top-k precision in f32.
    srcs = [logits, label]."""

    is_loss = True

    def setup(self, src_shapes):
        p = self.cfg.softmaxloss_param
        self.topk = p.topk if p else 1
        self.scale = p.scale if p else 1.0
        self.out_shape = (2,)   # metric blob layout [loss, precision]

    def apply(self, params, srcs, ctx):
        logits, labels = srcs
        if labels.dim() > 1:
            # sequence labels (B, S): token-level NLL over (B·S, V)
            logits = logits.reshape(-1, logits.shape[-1])
            labels = labels.reshape(-1)
        loss, prec = softmax_loss_metrics(logits.float(), labels, self.topk,
                                          self.scale)
        return {"loss": loss, "precision": prec}


# ---------------------------------------------------------------------------
# connector layers (base_layer.h:264-330, base_layer.cc:39-194): on one
# card these are identities or plain tensor ops


@register_layer("kConcate")
class ConcateLayer(Layer):
    def setup(self, src_shapes):
        self.dim = (self.cfg.concate_param.concate_dimension
                    if self.cfg.concate_param else 0)
        shape = list(src_shapes[0])
        shape[self.dim] = sum(s[self.dim] for s in src_shapes)
        self.out_shape = tuple(shape)

    def apply(self, params, srcs, ctx):
        return torch.cat(srcs, dim=self.dim)


@register_layer("kSlice")
class SliceLayer(Layer):
    """Cut along slice_dimension into slice_num views; consumer i reads
    view i (base_layer.cc:114-173), the last view taking the remainder
    (neuralnet.cc:160-162).  The output is the tuple of views."""

    def setup(self, src_shapes):
        p = self.cfg.slice_param
        self.dim = p.slice_dimension if p else 0
        self.num = p.slice_num if p else 1
        s = list(src_shapes[0])
        base, rem = divmod(s[self.dim], self.num)
        shapes = []
        for i in range(self.num):
            t = list(s)
            t[self.dim] = base + (rem if i == self.num - 1 else 0)
            shapes.append(tuple(t))
        self.out_shape = tuple(shapes)

    def apply(self, params, srcs, ctx):
        x = srcs[0]
        base = x.shape[self.dim] // self.num
        sizes = [base] * (self.num - 1)
        sizes.append(x.shape[self.dim] - base * (self.num - 1))
        return tuple(torch.split(x, sizes, dim=self.dim))


@register_layer("kSplit")
class SplitLayer(Layer):
    """Replicate to several consumers (base_layer.h:316-330): an
    identity."""

    def setup(self, src_shapes):
        self.out_shape = tuple(src_shapes[0])

    def apply(self, params, srcs, ctx):
        return srcs[0]


@register_layer("kBridgeSrc")
class BridgeSrcLayer(Layer):
    """Cross-location activation sender (base_layer.h:264-312): an
    identity on one card, kept for config parity."""

    def setup(self, src_shapes):
        self.out_shape = tuple(src_shapes[0])

    def apply(self, params, srcs, ctx):
        return srcs[0]


@register_layer("kBridgeDst")
class BridgeDstLayer(BridgeSrcLayer):
    pass


def create_layer(cfg: LayerConfig) -> Layer:
    if cfg.type not in LAYER_REGISTRY:
        # the sequence family and kRBM register on import
        from . import seq_layers  # noqa: F401
        from ..models import rbm  # noqa: F401
    if cfg.type not in LAYER_REGISTRY:
        raise LayerError(f"unknown layer type {cfg.type!r} "
                         f"(registered: {sorted(LAYER_REGISTRY)})")
    return LAYER_REGISTRY[cfg.type](cfg)
