"""The program's model configurations, built from the benchmark's files.

A configuration file holds the published sizes; these functions turn it
into the port's `ModelConfig` through the port's own public builders,
so the program runs exactly what the file states.
"""

from __future__ import annotations

from typing import Dict

from .reference.lm import dims


def lm_model_config(cfg: Dict, batch: int, seq: int):
    """The port's transformer LM at the file's widths: SwiGLU FFN,
    grouped-query attention with RoPE at the file's theta, RMSNorm at
    its epsilon, the head tied or not as the file says, the fused-head
    loss layer, the training precision and updater of the file."""
    from singa_tpu_torch import transformer_lm
    from singa_tpu_torch.config.schema import (config_to_dict,
                                               model_config_from_dict)
    m = dims(cfg)
    train = cfg["train"]
    base = transformer_lm(vocab_size=m["V"], num_layers=m["L"],
                          embed_dim=m["E"], num_heads=m["H"],
                          head_dim=m["D"], num_kv_heads=m["Hkv"],
                          ffn_hidden=m["F"], seq_len=seq, batchsize=batch,
                          precision=train["precision"],
                          tie_embeddings=cfg["tie_word_embeddings"],
                          fused_head=True)
    d = config_to_dict(base)
    for layer in d["neuralnet"]["layer"]:
        if layer["type"] == "kRMSNorm":
            layer["rmsnorm_param"] = {"epsilon": cfg["rms_norm_eps"]}
        elif layer["type"] == "kAttention":
            layer["attention_param"]["rope"] = True
            layer["attention_param"]["rope_theta"] = cfg["rope_theta"]
        elif layer["type"] == "kFeedForward":
            layer["ffn_param"]["activation"] = cfg["hidden_act"]
            layer["ffn_param"]["gated"] = True
    d["updater"] = dict(train["updater"])
    return model_config_from_dict(d)


def lm_shapes(seq: int) -> Dict:
    return {"data": {"input": (seq,), "target": (seq,)}}


def vision_model_config(cfg: Dict):
    """SINGA's conf as the file holds it, in the file's precision."""
    from singa_tpu_torch.config.schema import model_config_from_dict
    mc = model_config_from_dict(cfg["model"])
    mc.precision = cfg["train"]["precision"]
    mc.test_steps = 0
    return mc


def vision_shapes(cfg: Dict) -> Dict:
    return {"data": {"pixel": tuple(cfg["input"]["pixel"]), "label": ()}}
