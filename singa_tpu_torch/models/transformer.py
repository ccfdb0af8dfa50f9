"""Decoder-only transformer LM: its config function and synthetic data.

Port of `singa_tpu/models/transformer.py`: the same NetProto-style
config, layer for layer and name for name, so a JAX net and a port net
built from one call hold the same param keys.  Pre-norm blocks:

    x += attn(rmsnorm(x));  x += ffn_or_moe(rmsnorm(x))

`moe_every > 0` puts kMoE in place of kFeedForward in every
`moe_every`-th block.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..config.schema import ModelConfig, model_config_from_dict
from ..core import seq_layers  # noqa: F401  (registers the layer types)


def transformer_lm(vocab_size: int = 32000,
                   num_layers: int = 4,
                   embed_dim: int = 512,
                   num_heads: int = 8,
                   head_dim: int = 64,
                   num_kv_heads: int = 0,
                   ffn_hidden: int = 0,
                   seq_len: int = 1024,
                   batchsize: int = 8,
                   seq_parallel: str = "none",
                   moe_every: int = 0,
                   num_experts: int = 8,
                   experts_per_token: int = 2,
                   train_steps: int = 1000,
                   learning_rate: float = 3e-4,
                   precision: str = "float32",
                   tie_embeddings: bool = True,
                   fused_head: bool = True,
                   pipeline_stages: int = 0,
                   dropout: float = 0.0) -> ModelConfig:
    """`fused_head` emits the kLMHeadLoss layer (chunked projection+xent,
    no (B,S,V) logits tensor) instead of kLMHead → kSoftmaxLoss; the two
    forms are numerically identical.

    `pipeline_stages = S > 0` marks each block's layers with
    LayerProto.locationid 1..S (num_layers must divide evenly) — the
    reference's per-layer location field (model.proto:128) — which the
    Trainer maps onto the mesh's "pipe" axis via
    parallel.pipeline_net.PipelineNet.  Embedding and head keep
    locationid 0 (pre/post groups)."""
    ffn_hidden = ffn_hidden or int(embed_dim * 8 / 3 // 64 * 64) or 256
    layers: List[Dict] = [
        {"name": "data", "type": "kSequenceData",
         "seqdata_param": {"batchsize": batchsize, "seq_len": seq_len,
                           "vocab_size": vocab_size}},
        {"name": "labels", "type": "kSeqLabel", "srclayers": "data"},
        {"name": "embed", "type": "kEmbed", "srclayers": "data",
         "embed_param": {"vocab_size": vocab_size, "embed_dim": embed_dim}},
    ]
    if pipeline_stages:
        if num_layers % pipeline_stages:
            raise ValueError(f"num_layers {num_layers} not divisible by "
                             f"pipeline_stages {pipeline_stages}")
        per_stage = num_layers // pipeline_stages

    src = "embed"
    for i in range(num_layers):
        stage_mark = ({"locationid": i // per_stage + 1}
                      if pipeline_stages else {})
        attn_in = f"ln{i}a"
        layers.append({"name": attn_in, "type": "kRMSNorm",
                       "srclayers": src, **stage_mark})
        layers.append({
            "name": f"attn{i}", "type": "kAttention", "srclayers": attn_in,
            "attention_param": {
                "num_heads": num_heads, "head_dim": head_dim,
                "causal": True, "seq_parallel": seq_parallel,
                "num_kv_heads": num_kv_heads}, **stage_mark})
        layers.append({"name": f"res{i}a", "type": "kResidualAdd",
                       "srclayers": [src, f"attn{i}"], **stage_mark})
        ffn_in = f"ln{i}b"
        layers.append({"name": ffn_in, "type": "kRMSNorm",
                       "srclayers": f"res{i}a", **stage_mark})
        use_moe = moe_every > 0 and (i + 1) % moe_every == 0
        if use_moe:
            layers.append({
                "name": f"moe{i}", "type": "kMoE", "srclayers": ffn_in,
                "moe_param": {"num_experts": num_experts,
                              "experts_per_token": experts_per_token,
                              "expert_hidden": ffn_hidden}, **stage_mark})
            block_out = f"moe{i}"
        else:
            layers.append({
                "name": f"ffn{i}", "type": "kFeedForward",
                "srclayers": ffn_in,
                "ffn_param": {"hidden_dim": ffn_hidden}, **stage_mark})
            block_out = f"ffn{i}"
        layers.append({"name": f"res{i}b", "type": "kResidualAdd",
                       "srclayers": [f"res{i}a", block_out], **stage_mark})
        src = f"res{i}b"
        if dropout > 0:
            # block-output dropout (kDropout inside the stage mark — a
            # pipeline stage with rng-bearing layers is first-class)
            layers.append({"name": f"drop{i}", "type": "kDropout",
                           "srclayers": src,
                           "dropout_param": {"dropout_ratio": dropout},
                           **stage_mark})
            src = f"drop{i}"

    layers.append({"name": "ln_f", "type": "kRMSNorm", "srclayers": src})
    if fused_head:
        head = {"name": "loss", "type": "kLMHeadLoss",
                "srclayers": ["ln_f", "labels"],
                "embed_param": {"vocab_size": vocab_size,
                                "embed_dim": embed_dim},
                "softmaxloss_param": {"topk": 1}}
        if tie_embeddings:
            head["share_param"] = ["embed/embedding"]
            head["param"] = [{"name": "w"}]
        layers.append(head)
    else:
        head = {"name": "lm_head", "type": "kLMHead", "srclayers": "ln_f",
                "embed_param": {"vocab_size": vocab_size,
                                "embed_dim": embed_dim}}
        if tie_embeddings:
            head["share_param"] = ["embed/embedding"]
            head["param"] = [{"name": "w"}]
        layers.append(head)
        layers.append({"name": "loss", "type": "kSoftmaxLoss",
                       "srclayers": ["lm_head", "labels"],
                       "softmaxloss_param": {"topk": 1}})

    return model_config_from_dict({
        "name": f"transformer-lm-{num_layers}L{embed_dim}E",
        "train_steps": train_steps,
        "display_frequency": 50,
        "precision": precision,
        "updater": {"type": "kAdam", "base_learning_rate": learning_rate,
                    "weight_decay": 0.0,
                    "learning_rate_change_method": "kFixed"},
        "neuralnet": {"layer": layers},
    })


def synthetic_token_batches(batchsize: int, seq_len: int, vocab_size: int,
                            seed: int = 0, data_layer: str = "data",
                            table_seed: int = 1234):
    """Learnable synthetic LM data: Markov chains with a fixed random
    transition table — a model that learns beats the unigram entropy
    floor.  The table comes from `table_seed`, NOT `seed`, so train and
    test streams (different seeds) sample the same "language"."""
    import numpy as np
    rng = np.random.default_rng(seed)
    # sparse-ish transition: each (prev) maps to 4 likely next tokens
    nexts = np.random.default_rng(table_seed).integers(
        0, vocab_size, (vocab_size, 4))
    while True:
        toks = np.empty((batchsize, seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, vocab_size, batchsize)
        choices = rng.integers(0, 4, (batchsize, seq_len))
        noise = rng.random((batchsize, seq_len)) < 0.1
        rand_tok = rng.integers(0, vocab_size, (batchsize, seq_len))
        for t in range(seq_len):
            nxt = nexts[toks[:, t], choices[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand_tok[:, t], nxt)
        yield {data_layer: {"input": toks[:, :-1], "target": toks[:, 1:]}}
