"""The frozen FLOP and byte arithmetic against hand counts at a small
size, and against the program's own count as it stands."""

from __future__ import annotations

import json
import os

from conftest import ROOT, shrink

from bench_port.counts import flops


def tiny_lm():
    with open(os.path.join(ROOT, "bench_port/configs/mistral7b_l4.json")) as f:
        cfg = json.load(f)
    return shrink(cfg, {"batch": 2, "seq": 128})[0]


def test_lm_forward_by_hand():
    cfg = tiny_lm()                 # E 64, H 4 x 16, Hkv 2, F 96, V 320, L 2
    b, s = 2, 128
    t = b * s
    proj = 2 * t * 64 * (64 + 2 * 32 + 64)
    ffn = 2 * t * 64 * 96 * 3
    scores = 4 * b * 4 * s * s * 16 // 2
    head = 2 * t * 64 * 320
    assert flops.lm_forward_flops(cfg, b, s) == 2 * (proj + ffn + scores) \
        + head
    assert flops.lm_train_flops(cfg, b, s) == 3 * flops.lm_forward_flops(
        cfg, b, s)
    # a decoded token at context 10: products, QK^T and PV over 10, head
    per = 2 * 64 * (64 + 2 * 32 + 64) + 2 * 64 * 96 * 3 + 4 * 4 * 10 * 16
    assert flops.lm_decode_flops(cfg, 10) == 2 * per + 2 * 64 * 320


def test_attention_kernels_by_hand():
    b, s, h, hkv, d = 2, 256, 4, 2, 32
    pair = 2 * b * h * s * s * d // 2          # one causal product
    q, kv, rows = b * s * h * d * 2, b * s * hkv * d * 2, b * s * h * 4
    assert flops.attention_kernel_work("flash_fwd", b, s, h, hkv, d) == (
        2 * pair, 2 * q + 2 * kv + rows)
    assert flops.attention_kernel_work("flash_dq", b, s, h, hkv, d) == (
        3 * pair, 3 * q + 2 * kv + 2 * rows)
    assert flops.attention_kernel_work("flash_dkv", b, s, h, hkv, d) == (
        4 * pair, 2 * q + 4 * kv + 2 * rows)


def test_vision_by_hand():
    with open(os.path.join(ROOT,
                           "bench_port/configs/alexnet_cifar10.json")) as f:
        cfg = json.load(f)
    n = 4
    conv = (2 * n * 64 * 32 * 32 * 25 * 3 + 2 * n * 192 * 16 * 16 * 25 * 64
            + 2 * n * 384 * 8 * 8 * 9 * 192 + 2 * n * 256 * 8 * 8 * 9 * 384
            + 2 * n * 256 * 8 * 8 * 9 * 256)
    fc = 2 * n * (4096 * 4096 + 4096 * 4096 + 4096 * 10)
    assert flops.vision_forward_flops(cfg, n) == conv + fc
    assert flops.lrn_shapes(cfg, n) == [(n, 32, 32, 64), (n, 16, 16, 192)]
    assert flops.lrn_kernel_bytes("lrn_fwd", (n, 32, 32, 64)) == \
        2 * 2 * n * 32 * 32 * 64
    assert flops.lrn_kernel_bytes("lrn_bwd", (n, 32, 32, 64)) == \
        3 * 2 * n * 32 * 32 * 64


def test_frozen_copy_equals_the_program_today():
    from singa_tpu_torch import build_net
    from singa_tpu_torch.utils.flops import net_train_flops
    from bench_port.models import (lm_model_config, lm_shapes,
                                   vision_model_config, vision_shapes)
    cfg = tiny_lm()
    net = build_net(lm_model_config(cfg, 2, 128), "kTrain", lm_shapes(128))
    assert net_train_flops(net) == flops.lm_train_flops(cfg, 2, 128)
    with open(os.path.join(ROOT,
                           "bench_port/configs/alexnet_cifar10.json")) as f:
        al = json.load(f)
    net = build_net(vision_model_config(al), "kTrain", vision_shapes(al))
    assert net_train_flops(net) == flops.vision_train_flops(al, 1024)


def test_peaks_are_the_data_sheet():
    assert flops.peaks("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    assert flops.peaks("cpu") is None
