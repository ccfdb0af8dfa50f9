"""Sequence-model layer family of the port: the transformer LM's layers.

Port of `singa_tpu/core/seq_layers.py`, with the JAX package's default
partition dims (kEmbed's table on E, wq/wk/wv and w1/w3 on their
outputs, wo and w2 on their inputs, the LM heads' (E, V) weight on V,
kMoE's stacked experts on the "expert" axis; a ParamProto's
partition_dim wins).
kAttention keeps the JAX package's routes and their predicates:
the packed flash route (K1 on the card) when seq_parallel is "none",
S % 128 == 0 and head_dim % 8 == 0; ring or Ulysses attention over the
seq axis (`parallel/sequence.py`) for seq_parallel "ring" or "ulysses"
under a mesh; the strided flash route (K1 with one head per row) when
only the shape rule holds; and the dense `attention_reference`
otherwise, which is the JAX package's own behaviour for short or odd
sequences.

Under a mesh (`Context.tp`, `Context.seq`) each layer computes what
GSPMD computes from the params' shardings, with explicit collectives
(`parallel/comm.py`), and every layer's output is whole on every rank
of the model axis (GSPMD's global view): kAttention and kFeedForward
are Megatron pairs (column-parallel wq/wk/wv or w1/w3 on the rank's
heads or hidden units, row-parallel wo or w2, whose partial sums are
all-reduced); kEmbed gathers its E-sharded lookup; kLMHead gathers its
V-sharded logits; kLMHeadLoss gathers its weight at use (K2 needs whole
rows).  On a seq chunk RoPE takes the chunk's absolute positions, and
seq_parallel "none" attends over the gathered kv.

kLMHeadLoss takes the fused head
(K2) when the head is tied, top-1, kernel-legal and on the card, where
the JAX package asks for a TPU; elsewhere `chunked_lm_xent`.

kMoE runs `ops.moe.moe_ffn`, plain torch ops as the JAX package's XLA
op, and leaves its scaled router aux loss in `_aux` for `NeuralNet.apply`
to add to the objective.

Layer types: kSequenceData, kSeqLabel, kEmbed, kRMSNorm, kAttention,
kFeedForward, kMoE, kResidualAdd, kLMHead, kLMHeadLoss.
"""

from __future__ import annotations

import math
import sys
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..config.schema import ParamConfig
from ..ops import attention as attn_ops
from ..ops import head_loss, loss as loss_ops, moe as moe_ops
from .layers import Layer, LayerError, ParamSpec, _cast, register_layer
from .step_graph import mark, mark_grad

# (layer name, seq_len, head_dim) triples that already warned about the
# dense route
_dense_warned: set = set()


def _declare_with_default(layer: Layer, i: int, name: str, shape,
                          init_std: float, partition_dim: int = -1,
                          mesh_axis: Optional[str] = None) -> str:
    """Declare a param with a Gaussian default when the config gives no
    explicit ParamProto (transformer configs usually don't), with its
    default partition dim and mesh axis."""
    if i < len(layer.cfg.param):
        key = layer._declare(i, name, shape, fan_in=shape[0],
                             partition_dim=partition_dim)
        layer.param_specs[-1].mesh_axis = mesh_axis
        return key
    key = f"{layer.name}/{name}"
    layer.param_specs.append(ParamSpec(
        key, tuple(shape), shape[0],
        ParamConfig(init_method="kGaussain", mean=0.0, std=init_std),
        partition_dim, mesh_axis))
    return key


def _split(ctx, dims) -> bool:
    """Whether this rank holds each param of `dims` (key → dim) as a
    shard of that dim over the model axis."""
    return ctx.tp is not None and all(ctx.shard_dim(k) == d
                                      for k, d in dims.items())


def _positions(ctx, s: int, device) -> torch.Tensor:
    """The absolute positions of a local sequence of `s`: on a seq chunk
    they start at its first global position (`jnp.arange(S)` under
    GSPMD is global)."""
    first = ctx.seq.index * s if ctx.seq is not None else 0
    return torch.arange(first, first + s, device=device)


@register_layer("kSequenceData")
class SequenceDataLayer(Layer):
    """Token-sequence input: ctx.batch[name] = {"input": (B,S) int,
    "target": (B,S) int}."""

    is_data = True

    def setup(self, src_shapes, sample_shapes: Optional[Dict] = None):
        p = self.cfg.seqdata_param
        bs = p.batchsize if p else (self.cfg.data_param.batchsize
                                    if self.cfg.data_param else 0)
        seq = p.seq_len if p else 0
        self.batchsize, self.seq_len = bs, seq
        self.vocab_size = p.vocab_size if p else 0
        if sample_shapes:
            self.out_shape = {k: (bs,) + tuple(v)
                              for k, v in sample_shapes.items()}
        else:
            self.out_shape = {"input": (bs, seq), "target": (bs, seq)}

    def apply(self, params, srcs, ctx):
        return ctx.batch[self.name]


@register_layer("kEmbed")
class EmbedLayer(Layer):
    """Token embedding: (B, S) int → (B, S, E).  The table shards E
    over a model axis: each rank looks up its columns and they are
    gathered."""

    tp_aware = True

    def setup(self, src_shapes):
        p = self.cfg.embed_param
        if p is None or not p.vocab_size or not p.embed_dim:
            raise LayerError(f"{self.name}: embed_param vocab_size/embed_dim "
                             "required")
        src = src_shapes[0]
        shape = src["input"] if isinstance(src, dict) else tuple(src)
        self.out_shape = tuple(shape) + (p.embed_dim,)
        self.w_key = _declare_with_default(
            self, 0, "embedding", (p.vocab_size, p.embed_dim),
            init_std=1.0 / math.sqrt(p.embed_dim), partition_dim=1)
        self.embed_dim = p.embed_dim

    def apply(self, params, srcs, ctx):
        src = srcs[0]
        tokens = src["input"] if isinstance(src, dict) else src
        if _split(ctx, {self.w_key: 1}):
            from ..parallel import comm
            emb = _cast(params[self.w_key], ctx.compute_dtype)
            out = comm.all_gather(F.embedding(tokens.long(), emb), -1,
                                  ctx.tp.group)
            return out[..., :self.embed_dim]
        emb = _cast(ctx.full(params, self.w_key), ctx.compute_dtype)
        return F.embedding(tokens.long(), emb)


@register_layer("kSeqLabel")
class SeqLabelLayer(Layer):
    """Next-token targets from the sequence data dict."""

    def setup(self, src_shapes):
        self.out_shape = tuple(src_shapes[0]["target"])

    def apply(self, params, srcs, ctx):
        return srcs[0]["target"]


@register_layer("kRMSNorm")
class RMSNormLayer(Layer):
    def setup(self, src_shapes):
        p = self.cfg.rmsnorm_param
        self.eps = p.epsilon if p else 1e-6
        s = tuple(src_shapes[0])
        self.out_shape = s
        self.w_key = f"{self.name}/scale"
        self.param_specs.append(ParamSpec(
            self.w_key, (s[-1],), 0,
            ParamConfig(init_method="kConstant", value=1.0)))

    def apply(self, params, srcs, ctx):
        x = srcs[0]
        var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
        y = x * torch.rsqrt(var + self.eps).to(x.dtype)
        return y * params[self.w_key].to(x.dtype)


@register_layer("kAttention")
class AttentionLayer(Layer):
    """Multi-head (GQA) causal self-attention with RoPE.  Over a model
    axis that splits both head counts, each rank attends with its heads
    (column-parallel wq, wk, wv) and the partial products with its rows
    of wo are all-reduced."""

    tp_aware = True

    def setup(self, src_shapes):
        p = self.cfg.attention_param
        if p is None:
            raise LayerError(f"{self.name}: attention_param required")
        b, s, e = tuple(src_shapes[0])
        self.heads = p.num_heads
        self.kv_heads = p.num_kv_heads or p.num_heads
        self.head_dim = p.head_dim
        self.causal = p.causal
        self.seq_parallel = p.seq_parallel
        self.use_rope = p.rope
        self.rope_theta = p.rope_theta
        self.out_shape = (b, s, e)
        hd = self.heads * self.head_dim
        kvd = self.kv_heads * self.head_dim
        std = 1.0 / math.sqrt(e)
        self.wq = _declare_with_default(self, 0, "wq", (e, hd), std, 1)
        self.wk = _declare_with_default(self, 1, "wk", (e, kvd), std, 1)
        self.wv = _declare_with_default(self, 2, "wv", (e, kvd), std, 1)
        self.wo = _declare_with_default(self, 3, "wo", (hd, e), std, 0)

    def _proj(self, params, key, x):
        """x @ w in x's dtype, which is the compute dtype (the embedding
        casts once): an f32-accumulated product, as the JAX package's
        preferred_element_type einsum."""
        return torch.matmul(x, params[key].to(x.dtype))

    def qkv(self, params, x, positions, heads: int = 0, kv_heads: int = 0):
        """Projection + head split + RoPE, shared by `apply`'s strided
        routes and the KV-cache decode path (models/generate.py).
        `positions`: (S,) absolute token positions; `heads` and
        `kv_heads` (default: the layer's) are the head counts `params`
        project to.  Returns q (B, H, S, D) and k, v (B, Hkv, S, D),
        before GQA expansion."""
        heads, kv_heads = heads or self.heads, kv_heads or self.kv_heads
        b, s, e = x.shape
        q = self._proj(params, self.wq, x).reshape(
            b, s, heads, self.head_dim).transpose(1, 2)
        k = self._proj(params, self.wk, x).reshape(
            b, s, kv_heads, self.head_dim).transpose(1, 2)
        v = self._proj(params, self.wv, x).reshape(
            b, s, kv_heads, self.head_dim).transpose(1, 2)
        if self.use_rope:
            q = attn_ops.rope(q, positions, self.rope_theta)
            k = attn_ops.rope(k, positions, self.rope_theta)
        return q, k, v

    def _packed_eligible(self, s: int, ctx=None) -> bool:
        """The zero-transpose packed flash route (seq_layers.py:190-212):
        also under a mesh, on the rank's heads, where the sequence is
        whole on the rank."""
        return (self.seq_parallel == "none"
                and self.heads % self.kv_heads == 0
                and attn_ops.flash_legal(s, self.head_dim)
                and (ctx is None or ctx.seq is None))

    def apply(self, params, srcs, ctx):
        x = srcs[0]
        b, s, e = x.shape
        keys = {self.wq: 1, self.wk: 1, self.wv: 1, self.wo: 0}
        n = ctx.tp.group.n if ctx.tp is not None else 1
        group = None
        if (n > 1 and self.heads % n == 0 and self.kv_heads % n == 0
                and _split(ctx, keys)):
            from ..parallel import comm
            group = ctx.tp.group
            w, heads, kv_heads = params, self.heads // n, self.kv_heads // n
            x = comm.copy_to(x, group)
        else:
            w = {k: ctx.full(params, k) for k in keys}
            heads, kv_heads = self.heads, self.kv_heads
        out = self._attend(w, x, heads, kv_heads, ctx)
        y = self._proj(w, self.wo, out.to(x.dtype))
        if group is not None:
            from ..parallel import comm
            y = comm.all_reduce(y, group)
        return y

    def _attend(self, w, x, heads: int, kv_heads: int, ctx):
        """(B, S, heads·D) attention output of this rank's heads."""
        b, s, e = x.shape
        positions = _positions(ctx, s, x.device)
        if self._packed_eligible(s, ctx):
            # (B, S, H·D) end to end: the projections feed K1 directly
            # and its output feeds wo directly.  Over a model axis these
            # are the rank's heads (the JAX package's
            # packed_attention_sharded): head groups stay aligned, since
            # both head counts divide by the axis
            q = self._proj(w, self.wq, x)
            k = self._proj(w, self.wk, x)
            v = self._proj(w, self.wv, x)
            if self.use_rope:
                q = attn_ops.rope_packed(q, positions, heads,
                                         self.rope_theta)
                k = attn_ops.rope_packed(k, positions, kv_heads,
                                         self.rope_theta)
            return attn_ops.flash_attention_packed(q, k, v, heads,
                                                   self.causal, kv_heads)
        q, k, v = self.qkv(w, x, positions, heads, kv_heads)
        if ctx.seq is not None and self.seq_parallel in ("ring",
                                                          "ulysses"):
            # kv stays at Hkv width: the ring rotates (and Ulysses
            # all-to-alls) unexpanded kv.  Without a seq axis the layer
            # takes the strided route below, whole-sequence attention
            # as the JAX package's dense one under a seq axis of 1
            from ..parallel import sequence
            fn = (sequence.ring_attention if self.seq_parallel == "ring"
                  else sequence.ulysses_attention)
            out = fn(q, k, v, ctx.seq, self.causal)
        elif ctx.seq is not None:
            # a seq chunk without a seq-parallel route: attend over the
            # whole sequence's kv, gathered (every rank's q reaches every
            # rank's kv, so their gradients are summed over the axis)
            from ..parallel import comm
            kk = comm.all_gather(k, 2, ctx.seq, reduce_grad=True)
            vv = comm.all_gather(v, 2, ctx.seq, reduce_grad=True)
            out, _ = attn_ops.chunk_attention(
                q, attn_ops.expand_kv_heads(kk, heads),
                attn_ops.expand_kv_heads(vv, heads), self.causal,
                ctx.seq.index * s, 0)
            out = out.to(q.dtype)
        else:
            k = attn_ops.expand_kv_heads(k, heads)
            v = attn_ops.expand_kv_heads(v, heads)
            if attn_ops.flash_legal(s, self.head_dim):
                out = attn_ops.flash_attention(q, k, v, self.causal)
            else:
                key = (self.cfg.name, s, self.head_dim)
                if key not in _dense_warned:
                    _dense_warned.add(key)
                    print(f"warning: attention layer {self.cfg.name!r} "
                          f"(seq_len={s}, head_dim={self.head_dim}) takes "
                          f"dense O(S^2)-memory attention — the flash "
                          f"kernel route needs seq_len % 128 == 0 and "
                          f"head_dim % 8 == 0", file=sys.stderr)
                out = attn_ops.attention_reference(q, k, v, self.causal)
        return out.transpose(1, 2).reshape(b, s, -1)


_ACTIVATIONS = {
    "silu": F.silu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


@register_layer("kFeedForward")
class FeedForwardLayer(Layer):
    """Gated (SwiGLU) or plain MLP over (B, S, E).  Over a model axis
    each rank computes its hidden units (column-parallel w1, w3) and the
    partial products with its rows of w2 are all-reduced; a hidden dim
    the axis does not divide is zero-padded, which adds exact zeros."""

    tp_aware = True

    def setup(self, src_shapes):
        p = self.cfg.ffn_param
        if p is None or not p.hidden_dim:
            raise LayerError(f"{self.name}: ffn_param.hidden_dim required")
        b, s, e = tuple(src_shapes[0])
        f = p.hidden_dim
        if p.activation not in _ACTIVATIONS:
            raise LayerError(f"{self.name}: unknown ffn activation "
                             f"{p.activation!r} (silu|gelu|relu)")
        self.activation = p.activation
        self.gated = p.gated
        self.out_shape = (b, s, e)
        std = 1.0 / math.sqrt(e)
        self.w1 = _declare_with_default(self, 0, "w1", (e, f), std, 1)
        self.w2 = _declare_with_default(self, 1, "w2", (f, e),
                                        1.0 / math.sqrt(f), 0)
        if self.gated:
            self.w3 = _declare_with_default(self, 2, "w3", (e, f), std, 1)

    def apply(self, params, srcs, ctx):
        x = srcs[0]
        keys = {self.w1: 1, self.w2: 0}
        if self.gated:
            keys[self.w3] = 1
        group = ctx.tp.group if _split(ctx, keys) else None
        if group is not None:
            from ..parallel import comm
            x = comm.copy_to(x, group)

        def w(key):     # x is in the compute dtype (see AttentionLayer)
            t = params[key] if group is not None else ctx.full(params, key)
            return t.to(x.dtype)
        h = _ACTIVATIONS[self.activation](torch.matmul(x, w(self.w1)))
        if self.gated:
            h = h * torch.matmul(x, w(self.w3))
        y = torch.matmul(h, w(self.w2))
        if group is not None:
            from ..parallel import comm
            y = comm.all_reduce(y, group)
        return y


@register_layer("kMoE")
class MoELayer(Layer):
    """Mixture-of-experts FFN over (B, S, E): top-k routing over
    `num_experts` expert FFNs with stacked weights."""

    def setup(self, src_shapes):
        p = self.cfg.moe_param
        if p is None:
            raise LayerError(f"{self.name}: moe_param required")
        b, s, e = tuple(src_shapes[0])
        self.n_exp = p.num_experts
        self.k = p.experts_per_token
        self.capacity_factor = p.capacity_factor
        self.aux_coef = p.router_aux_coef
        f = p.expert_hidden or 4 * e
        self.out_shape = (b, s, e)
        std = 1.0 / math.sqrt(e)
        n = self.n_exp
        self.router = _declare_with_default(self, 0, "router", (e, n), std)
        # the stacked experts shard over the "expert" axis
        # (`ops/moe.py`); under a model axis alone they stay whole
        self.w1 = _declare_with_default(self, 1, "w1", (n, e, f), std, 0,
                                        "expert")
        self.b1 = _declare_with_default(self, 2, "b1", (n, f), 0.0, 0,
                                        "expert")
        self.w2 = _declare_with_default(self, 3, "w2", (n, f, e),
                                        1.0 / math.sqrt(f), 0, "expert")
        self.b2 = _declare_with_default(self, 4, "b2", (n, e), 0.0, 0,
                                        "expert")
        self._aux = None

    def apply(self, params, srcs, ctx):
        # every param in the compute dtype, the router too: in bf16 it
        # is rounded before moe_ffn upcasts it for the f32 product
        p = {name: _cast(params[key], ctx.compute_dtype)
             for name, key in (("router", self.router), ("w1", self.w1),
                               ("b1", self.b1), ("w2", self.w2),
                               ("b2", self.b2))}
        out, aux = moe_ops.moe_ffn(srcs[0], p, self.k, self.capacity_factor,
                                   split=ctx.tokens, experts=ctx.experts)
        self._aux = self.aux_coef * aux
        return out


@register_layer("kResidualAdd")
class ResidualAddLayer(Layer):
    """out = srcs[0] + srcs[1] — explicit residual edges in the DAG."""

    def setup(self, src_shapes):
        self.out_shape = tuple(src_shapes[0])

    def apply(self, params, srcs, ctx):
        return srcs[0] + srcs[1]


class _HeadProjection:
    """Shared head projection for the LM head layers, used by `apply`
    and the KV-cache decode path (models/generate.py) alike."""

    def head_weight(self, params, compute_dtype=None):
        """(weight, is_vE): the raw (V, E) embedding table when tied;
        consumers contract E on the last dim instead of transposing."""
        return _cast(params[self.w_key], compute_dtype), self.tied

    def project_logits(self, params, hidden, compute_dtype=None):
        """(B, S, E) hidden → (B, S, V) float32 logits."""
        w, is_vE = self.head_weight(params, compute_dtype)
        w = w.float()
        return torch.matmul(hidden.float(), w.T if is_vE else w)


@register_layer("kLMHead")
class LMHeadLayer(Layer, _HeadProjection):
    """(B, S, E) → (B, S, V) logits; optionally tied to the embedding via
    share_param.  An untied (E, V) weight shards V over a model axis:
    each rank projects onto its vocab columns and the logits are
    gathered; a tied one is gathered whole at use."""

    tp_aware = True

    def setup(self, src_shapes):
        p = self.cfg.embed_param
        if p is None or not p.vocab_size:
            raise LayerError(f"{self.name}: embed_param.vocab_size required")
        b, s, e = tuple(src_shapes[0])
        self.out_shape = (b, s, p.vocab_size)
        self.tied = bool(self.cfg.share_param)
        self.vocab_size = p.vocab_size
        self.w_key = _declare_with_default(
            self, 0, "w", (e, p.vocab_size), 1.0 / math.sqrt(e), 1)

    def apply(self, params, srcs, ctx):
        if not self.tied and _split(ctx, {self.w_key: 1}):
            from ..parallel import comm
            group = ctx.tp.group
            logits = self.project_logits(params, comm.copy_to(srcs[0], group),
                                         ctx.compute_dtype)
            return comm.all_gather(logits, -1, group)[..., :self.vocab_size]
        return self.project_logits({self.w_key: ctx.full(params, self.w_key)},
                                   srcs[0], ctx.compute_dtype)


@register_layer("kLMHeadLoss")
class LMHeadLossLayer(Layer, _HeadProjection):
    """Fused LM head + softmax-xent + top-k precision: (B, S, E) hidden +
    (B, S) labels → metrics, without a (B, S, V) logits tensor."""

    is_loss = True

    def setup(self, src_shapes):
        p = self.cfg.embed_param
        if p is None or not p.vocab_size:
            raise LayerError(f"{self.name}: embed_param.vocab_size required")
        b, s, e = tuple(src_shapes[0])
        lp = self.cfg.softmaxloss_param
        self.topk = lp.topk if lp else 1
        self.scale = lp.scale if lp else 1.0
        self.chunk = p.loss_chunk or 4096
        self.tied = bool(self.cfg.share_param)
        self.w_key = _declare_with_default(
            self, 0, "w", (e, p.vocab_size), 1.0 / math.sqrt(e), 1)
        self.flops_shape = (b, s, e, p.vocab_size)   # for utils.flops
        self.out_shape = (2,)

    def _use_fused(self, h2, w, is_vE) -> bool:
        """Whether K2 applies: tied (V, E) layout, top-1 metric,
        kernel-legal shapes, tensors on the card."""
        return (self.topk == 1 and is_vE and h2.is_cuda
                and head_loss.eligible(h2, w))

    def apply(self, params, srcs, ctx):
        hidden, labels = srcs
        # the head's device marks in a captured train step: its forward
        # from the weight's cast, its backward up to the hidden's
        # gradient (`core/step_graph.py`; nothing when not captured)
        mark("head.start")
        hidden = mark_grad(hidden, "head.grad")
        w, is_vE = self.head_weight(params, ctx.compute_dtype)
        b, s, e = hidden.shape
        h2, l2 = hidden.reshape(b * s, e), labels.reshape(-1)
        if self._use_fused(h2, w, is_vE):
            loss, prec = head_loss.fused_lm_xent(h2.contiguous(),
                                                 w.contiguous(), l2,
                                                 self.scale, self.chunk)
        else:
            loss, prec = loss_ops.chunked_lm_xent(
                h2, w, l2, chunk_size=self.chunk, topk=self.topk,
                scale=self.scale, w_is_vE=is_vE)
        mark("head.end")
        return {"loss": loss, "precision": prec}
