#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (singa_tpu_torch), one GPU.

    python3 chip_smoke.py

run from the root of a checkout, on a machine with one NVIDIA H100 and
the CUDA toolkit.  Phases, none of them caught — any failure exits
non-zero before the last line is printed:

1. Card and build: the card's name and power limit, then nvcc builds
   every kernel from singa_tpu_torch/csrc (one process per source, in
   parallel); build time, each kernel's ptxas registers and spills, and
   the HMMA (tensor-core) instructions of K1-K4 by `cuobjdump -sass`
   (their bf16 bodies must have some).
2. K1 and K2 against their plain PyTorch versions on the card, at the
   bench shapes, at lm.conf's strided geometry (one head of 32 per row
   over B·H = 64 rows, S = 512, bf16, causal; timed too) and a few more
   (GQA, non-causal, every head dim, both
   dtypes, ragged edges; for K2 vocabs that are not a multiple of its
   split and an exact tie across a split boundary), each with its
   stated tolerance; kernel times on the card's clock by a CUDA-graph
   replay of direct launches (SDPA's forward and, for K2, the bare
   h.W^T product likewise), with the wrapper's host time, TFLOP/s and
   share of the bound beside them; plain times by CUDA events.
3. The scoring forward: the repo's bench stack (transformer_lm 12L,
   E=768, 12 heads of 64, V=32768, S=1024, B=8, bf16 compute) with
   random weights from a numpy seed, through
   `NeuralNet.apply(train=False)`.  The launch counts are set to 0 just
   before and read just after: K1 must run 12 times and K2 once.  Then
   the same weights at 2 layers and batch 2 on the card and on the CPU:
   each attention layer's output, K2's per-token lse, label logit and
   hit, and the loss must agree.  Then the eval step:
   `Trainer.evaluate` over 10 bench batches, as CUDA-graph replays and
   eagerly, in turns: tokens/s, a profiled step's idle share, K1 12 and
   K2 once per batch, and averages equal to the bit.
4. Serving, on the same stack with f32 weights.  4a, the bucketed
   engine: warm-up must capture one CUDA graph per (mode, bucket)
   (generate is the whole unrolled decode); replayed greedy answers must
   equal eager (`graphs=False`) ones and `generate` on the unpadded
   prompts, predict must match `forward_cached`, seeded sampling must
   give the same tokens on two engines and on an eager one; tokens/s
   replayed and eager in turns, the idle share of each, and no capture
   after warm-up.  4b, continuous batching (`ContinuousScheduler`,
   32 slots, blocks of 16, prompts up to 512, 128 new tokens at most,
   1281 pool blocks: 1.51 GB of f32 pools, which `pool_bytes` must
   match): 96 greedy requests (lengths and max_new from numpy seed 11)
   submitted before `start()` must all finish with `length`, 0 failed,
   no capture after the two graphs of warm-up; the 4 shortest and 4
   longest answers must equal `generate` (a differing token must sit at
   a top-2 logit gap below 1e-4, which is printed), and an eager engine
   must give every answer equal; 32 sampled requests must give the same
   tokens twice; the decode step with all 32 slots active and the
   prefill, replayed and eager in turns, profiles, generated tokens/s,
   latency and queue-wait percentiles and peak memory.  No kernel of
   K1-K6 runs on the serving path.
5. K3 and K4 (the flash backward) against their plain versions, at the
   bench shape and at lm.conf's strided geometry (both timed as K1, with
   SDPA's backward as the library yardstick), and at GQA, non-causal,
   every head dim on ragged S in both dtypes, and with an lse cotangent.
6. Gradients, card against CPU: one `Trainer.gradients` of the 2-layer
   stack at batch 2 on both devices from the same weights; every param
   must get a gradient on both, within a stated share of its largest
   magnitude, and the card's run must launch K1, K3 and K4 twice each
   and K2 once.
7. Training, the LM main path: `Trainer.train_step` takes Adam steps
   of the full 12-layer bench stack at B=8 on synthetic token batches,
   as CUDA-graph replays (`graphs=None` must capture on the card); each
   replay must add K1, K3, K4 12 and K2 one launch to the counts (the
   capture's recorded launches), a profiled replay must hold those
   kernels by name, and the loss must fall.  Step time, tokens/s, an
   eager step's forward / backward / update split and the profile are
   printed.  Then eager steps (`graphs=False`) against replays from one
   copied start: after 10 steps, and again after 51, params and Adam
   state must be equal under `torch.equal`; between them 3 rounds of 10
   steps each in turns (tokens/s), `train_steps(10)` with one sync, a
   profiled step each (idle share) and the peak memory of each.  Then
   checkpoints: at 2 layers, every trainer captured, `Trainer.run`
   saves after k steps, a captured `Trainer` (its graph taken over other
   params first) resumes from the snapshot and continues, and its params
   must equal an uninterrupted chunked (`scan_chunk=4`) run's bit for
   bit.
8. K5 and K6 (the LRN forward and backward) against their plain
   versions at AlexNet-CIFAR10's norm1 and norm2 shapes (B=1024, relu
   fused, bf16 and f32; timed in bf16 by a CUDA-graph replay of direct
   launches, with the wrapper's host time, the share of the bound and
   `F.local_response_norm` on relu(x) as the library yardstick), at a
   ragged shape (N=3, C=13, L=3, beta=0.5, relu off), at C=3000 (one
   pixel per block), and at the vector route's edges in both dtypes:
   C=8, C=16 with L=9, C=2056, a runtime window and beta, pixel counts
   that are not a multiple of the tile, and a view one element into its
   storage (the general route at C=64).
9. AlexNet-CIFAR10, slice 3's main path: `examples/cifar10/
   alexnet.conf` through the port's config parser at full width, its own
   batch 1024, bf16 compute, numpy-seeded weights, synthetic CIFAR-shaped
   batches: the Trainer must pick eager steps (`graphs=None`; dropout
   and the mirror draw per step), then 20 kSGD steps through
   `Trainer.train_step` and two more
   through `Trainer.train_steps`, each step launching K5 and K6 twice and
   K1-K4 never; images/s, the step's split, a profile and peak memory;
   the eval step through `Trainer.evaluate` (K5 twice per step); then
   the same weights at batch 4 in f32 on the card and on the CPU, whose
   loss and every gradient must agree.

10. `examples/transformer/lm.conf` uncut (B=8, S=512, V=4096, E=256,
   2 blocks, block 1 a kMoE of 4 experts top-2; its attention takes
   the strided flash route; bf16, Adam) with numpy-seeded weights.
   (a) One forward and every gradient on the card and on the CPU: the
   share of tokens whose top-2 expert set (and capacity drops) agree,
   each attention output, kMoE's output on the tokens routed alike,
   the loss, and every gradient of the loss over the tokens routed
   alike, within stated shares of their largest magnitudes; K1, K3, K4
   twice each, K2 never.  (b) Eager steps
   against CUDA-graph replays (`graphs=None` must capture) from one
   copied start: equal under `torch.equal` after 10 steps (counts set
   to 0 just before the replays: 2/2/2 per step, the capture's record)
   and again after 51; 3 rounds of 10 in turns, `train_steps(10)`, a
   profiled step of each (idle share; the replay's kernels by name);
   the loss over the 51 steps on 10 repeated batches must fall and
   `moe1/aux` stay finite; kMoE's forward and backward alone, profiled:
   its products against its dispatch, beside the step's busy time.
   (c) `beam_search` (4 beams) and greedy `generate`, 32 new tokens
   from two 64-token prompts in f32, card against CPU, with the first
   divergence and its top-2 gap where tokens differ.  (d) Serving in
   f32: one bucket (8, 128) x 32 replayed against eager (equal tokens,
   tokens/s in turns), and 24 continuous-batching requests over 8 slots
   replayed against eager (all served, the same answers; a MoE shares
   each expert's capacity among the rows of a call, so answers are not
   held against `generate`).

Every result line ends with the card's `nvidia-smi` name and power
limit.  The last lines are one JSON object listing each kernel with its
launches (K1-K4 over phase 7's training run, K5/K6 over phase 9's),
error, times and bound; the card's `nvidia-smi` name and power limit;
and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data sheet, dense: bf16 tensor cores, f32 outside them, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

# card against CPU at 2 layers (compare_small), about 4x the gaps an
# H100 showed: attn0/attn1 0.0078/0.0156 (one bf16 ulp at their largest
# magnitude, 3.6/3.3), per-token lse 0.0072, label logit 0.035
ATTN_RTOL = 2 ** -6     # of the layer output's largest magnitude
LSE_ATOL = 0.03
LL_ATOL = 0.15
LOSS_RTOL = 1e-4

BENCH = dict(vocab_size=32768, num_layers=12, embed_dim=768, num_heads=12,
             head_dim=64, seq_len=1024, batchsize=8)
EVAL_BATCHES = 10       # phase 3's Trainer.evaluate, captured and eager


CARD = ""               # nvidia-smi's name and power limit, set by main()


def log(msg: str) -> None:
    """A line of results, with the card's name and power limit once
    main() has read them."""
    print(f"{msg} [{CARD}]" if CARD else msg, flush=True)


def trainer_log(msg: str) -> None:
    log(f"[trainer] {msg}")


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of `fn` over `iters` back-to-back calls, by CUDA
    events after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Mean device time of one `fn` call on the card's own clock: CUDA
    events around replays of a CUDA graph that holds `n` calls, so no
    host time between launches is counted.  `fn` launches into
    preallocated outputs (a direct `_kernels.launch`) or allocates from
    the graph's own pool."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                        # warm-up, outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * reps)


def host_ms(fn, n: int = 50) -> float:
    """Host time of one `fn` call (enqueue only: no synchronise inside
    the loop), the wrapper's cost on the host's clock."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e3 / n


def rate_line(name: str, res: dict, flops: float) -> str:
    """Achieved TFLOP/s and the share of the bound, from the graph-timed
    kernel time."""
    return (f"[kernels] {name}: {flops / res['ms'] / 1e9:.1f} TFLOP/s, "
            f"{res['bound_ms'] / res['ms']:.3f} of the bound "
            f"({res['bound_by']}); wrapper {res['wrapper_ms']:.4f} ms per "
            f"call on the host")


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profile(tag: str, fn, wall_ms: float, top: int = 8) -> dict:
    """One traced call of `fn`: device time and events by kernel name,
    and the device's busy and idle share of `wall_ms`, an untraced call's
    time.  Returns the busy ms, the idle share and the events by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    counts: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
            counts[e.name] = counts.get(e.name, 0) + 1
    busy = sum(by_name.values())
    if not by_name:
        log(f"[profile] {tag}: the profiler recorded no device time "
            f"(busy share not measured)")
        return {"busy_ms": None, "idle": None, "counts": {}, "ms": {}}
    idle = max(0.0, 1 - busy / wall_ms)
    log(f"[profile] {tag}: device busy {busy:.3f} ms of {wall_ms:.3f} ms "
        f"untraced wall, idle share {idle:.3f}, {len(by_name)} kernel "
        f"names, {sum(counts.values())} device events")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"[profile] {tag}:   {t:9.3f} ms  {100 * t / busy:5.1f}%  "
            f"{counts[name]:4d}x  {name[:90]}")
    return {"busy_ms": busy, "idle": idle, "counts": counts, "ms": by_name}


def count_named(counts: dict, names) -> dict:
    """Device events of a profile whose kernel name holds each of
    `names` as a whole word."""
    return {n: sum(c for k, c in counts.items()
                   if re.search(rf"\b{n}\b", k)) for n in names}


def _short(symbols) -> dict:
    """Mangled kernel names -> `name<template args>`, by c++filt (part of
    the binutils that nvcc builds with)."""
    symbols = list(symbols)
    names = subprocess.run(["c++filt"], input="\n".join(symbols),
                           capture_output=True, text=True,
                           check=True).stdout.splitlines()
    return {sym: name.replace("(anonymous namespace)::", "")
            .split("(")[0].replace("void ", "")
            for sym, name in zip(symbols, names)}


def ptxas_usage(text: str) -> list:
    """(kernel, 'registers; stack and spill bytes') for each entry that
    `nvcc -Xptxas -v` reports in `text`."""
    rows, fn, spill = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn, spill = m.group(1), ""
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and fn:
            used = line.split(":", 1)[-1].strip()
            rows.append((fn, f"{used}; {spill}"))
            fn = None
    names = _short(f for f, _ in rows)
    return [(names[f], u) for f, u in rows]


def sass_hmma(name: str) -> dict:
    """HMMA (tensor-core) instructions per kernel in the built library of
    kernel `name`, read by the toolkit's `cuobjdump -sass` (beside the
    nvcc that built it)."""
    from singa_tpu_torch.ops import _kernels
    tool = os.path.join(os.path.dirname(_kernels._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_kernels._target(name))],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split(":", 1)[1].strip()
            counts[fn] = 0
        elif fn and "HMMA" in line:
            counts[fn] += 1
    names = _short(counts)
    return {names[f]: n for f, n in counts.items()}


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions


def check_flash(b, s, h, hkv, d, dtype, causal, dev, seed, timed=False):
    from singa_tpu_torch.ops import attention as A
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, s, h * d), generator=g, device=dev).to(dtype)
    k = torch.randn((b, s, hkv * d), generator=g, device=dev).to(dtype)
    v = torch.randn((b, s, hkv * d), generator=g, device=dev).to(dtype)
    out, lse = A.flash_attention_packed_lse(q, k, v, h, causal, hkv)
    torch.cuda.synchronize()
    ref_out, ref_lse = A.flash_forward_plain(q, k, v, h, causal, hkv)
    err_o = (out.float() - ref_out.float()).abs().max().item()
    err_l = (lse - ref_lse).abs().max().item()
    # both sides compute in f32 (in bf16 both round P before P.V) and
    # differ only in summation order; a bf16 output may then round one
    # ulp apart (|O| < 4: ulp <= 2^-6)
    tol_o = 2e-2 if dtype == torch.bfloat16 else 1e-4
    tol_l = 1e-3
    tag = (f"K1 flash_fwd b={b} s={s} h={h} hkv={hkv} d={d} "
           f"{str(dtype).split('.')[-1]} causal={causal}")
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    assert err_o <= tol_o and err_l <= tol_l, (tag, err_o, err_l)
    res = {"max_abs_err": err_o}
    if timed:
        from singa_tpu_torch.ops import _kernels
        o_buf, l_buf = torch.empty_like(out), torch.empty_like(lse)
        res["ms"] = graph_ms(lambda: _kernels.launch(
            "flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o_buf.data_ptr(), l_buf.data_ptr(), b, s, s, h, hkv, d,
            int(causal), A.fold_constant(d, dtype), A._DTYPE_CODE[dtype]))
        res["wrapper_ms"] = host_ms(lambda: A.flash_attention_packed_lse(
            q, k, v, h, causal, hkv))
        res["plain_ms"] = time_ms(lambda: A.flash_forward_plain(
            q, k, v, h, causal, hkv), 5, 1)
        qs = q.view(b, s, h, d).transpose(1, 2)
        ks = k.view(b, s, hkv, d).transpose(1, 2)
        vs = v.view(b, s, hkv, d).transpose(1, 2)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        res["library_ms"] = (graph_ms(lambda: sdpa(qs, ks, vs,
                                                   is_causal=causal))
                             if h == hkv else None)
        pairs = s * (s + 1) // 2 if causal else s * s
        esz = q.element_size()
        nbytes = (2 * b * s * h * d + 2 * b * s * hkv * d) * esz \
            + b * s * h * 4
        flops = 4.0 * d * pairs * b * h
        res["bound_ms"], res["bound_by"] = bound(nbytes, flops, dtype)
    log(f"[kernels] {tag}: max|dO| {err_o:.3g} (tol {tol_o}), "
        f"max|dlse| {err_l:.3g} (tol {tol_l})"
        + (f", kernel {res['ms']:.4f} ms (graph), plain "
           f"{res['plain_ms']:.4f} ms, sdpa {res['library_ms']} ms "
           f"(graph), bound {res['bound_ms']:.4f} ms ({res['bound_by']})"
           if timed else ""))
    if timed:
        log(rate_line("K1 flash_fwd", res, flops))
        if res["library_ms"]:
            log(f"[kernels] K1 flash_fwd: {res['ms'] / res['library_ms']:.2f}"
                f"x SDPA's forward in this run")
    return res


def head_inputs(n, e, v, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn((n, e), generator=g, device=dev).to(dtype)
    w = (torch.randn((v, e), generator=g, device=dev)
         / math.sqrt(e)).to(dtype)
    labels = torch.randint(0, v, (n,), generator=g, device=dev)
    return h, w, labels


def check_head(n, e, v, dtype, dev, seed, timed=False, inputs=None):
    from singa_tpu_torch.ops import head_loss as H
    h, w, labels = inputs or head_inputs(n, e, v, dtype, dev, seed)
    lse, ll, hit = H.head_stats(h, w, labels)
    torch.cuda.synchronize()
    r_lse, r_ll, r_hit = H.head_stats_plain(h, w, labels)
    err = max((lse - r_lse).abs().max().item(),
              (ll - r_ll).abs().max().item())
    agree = (hit == r_hit).float().mean().item()
    # f32 sums of E exact products (both dtypes) in another order: ~1e-6
    # relative; a hit may flip only where the two best logits tie that
    # closely
    tag = f"K2 head_fwd n={n} e={e} v={v} {str(dtype).split('.')[-1]}"
    assert torch.isfinite(lse).all() and torch.isfinite(ll).all()
    assert torch.allclose(lse, r_lse, rtol=1e-4, atol=1e-4), tag
    assert torch.allclose(ll, r_ll, rtol=1e-4, atol=1e-4), tag
    assert agree >= 0.999, (tag, agree)
    res = {"max_abs_err": err, "hit": hit}
    if timed:
        from singa_tpu_torch.ops import _kernels
        lbl = labels.to(torch.int32)
        outs = torch.empty((3, n), dtype=torch.float32, device=dev)
        ranges, per = H.v_splits(v)
        ws = torch.empty((ranges, n, 4), dtype=torch.float32, device=dev)
        res["ms"] = graph_ms(lambda: _kernels.launch(
            "head_fwd", h.data_ptr(), w.data_ptr(), lbl.data_ptr(),
            outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(),
            ws.data_ptr(), n, e, v, per, H._DTYPE_CODE[dtype]))
        res["wrapper_ms"] = host_ms(lambda: H.head_stats(h, w, labels))
        res["plain_ms"] = time_ms(lambda: H.head_stats_plain(h, w, labels),
                                  3, 1)
        res["library_ms"] = None
        esz = h.element_size()
        res["bound_ms"], res["bound_by"] = bound(
            (n * e + v * e) * esz + n * 8 + 3 * n * 4, 2.0 * n * v * e,
            dtype)
        # a reference, not K2's library column: the bare product with an
        # f32 output (cuBLAS), without the statistics, writing n*v logits
        res["mm_ms"] = graph_ms(lambda: torch.mm(
            h, w.T, out_dtype=torch.float32), n=5)
    log(f"[kernels] {tag}: max err {err:.3g} (rtol/atol 1e-4), hit "
        f"agreement {agree:.5f} (>= 0.999)"
        + (f", kernel {res['ms']:.4f} ms (graph), plain "
           f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
           f"({res['bound_by']})" if timed else ""))
    if timed:
        log(rate_line("K2 head_fwd", res, 2.0 * n * v * e))
        log(f"[kernels] K2 head_fwd: reference, the bare product torch.mm("
            f"h, w.T, out_dtype=float32) at the same shape "
            f"{res['mm_ms']:.4f} ms (graph; {n * v * 4 / 2 ** 30:.2f} GiB "
            f"of logits, no statistics): K2 is "
            f"{res['ms'] / res['mm_ms']:.2f}x it")
    return res


def check_head_tie(n, e, v, dtype, dev, seed):
    """Columns b - 1 and b, the last of K2's first vocab range and the
    first of its second, hold equal rows of W whose logit (exactly 8)
    beats every other: the hit must name the lower column, exactly."""
    from singa_tpu_torch.ops import head_loss as H
    h, w, labels = head_inputs(n, e, v, dtype, dev, seed)
    _, per = H.v_splits(v)
    b = per * H.MMA_BV
    h[:, 0] = 8.0
    w[:, 0] = 0.0
    w[b - 1] = w[b] = 0.0
    w[b - 1, 0] = w[b, 0] = 1.0
    labels[labels == b - 1] = 0
    labels[: n // 2] = b - 1
    labels[n // 2: 3 * n // 4] = b
    hit = check_head(n, e, v, dtype, dev, seed,
                     inputs=(h, w, labels))["hit"]
    want = (torch.arange(n, device=dev) < n // 2).float()
    assert torch.equal(hit, want), ("tie across a split", dtype)
    log(f"[kernels] K2 head_fwd n={n} e={e} v={v} "
        f"{str(dtype).split('.')[-1]}: exact tie across the split at "
        f"column {b}: every hit names column {b - 1}")


def phase_kernels(dev):
    bf16, f32 = torch.bfloat16, torch.float32
    k1 = check_flash(8, 1024, 12, 12, 64, bf16, True, dev, 1, timed=True)
    # lm.conf's strided route: one head of 32 per row over B·H = 64 rows
    check_flash(64, 512, 1, 1, 32, bf16, True, dev, 100, timed=True)
    check_flash(8, 1024, 12, 4, 64, bf16, True, dev, 2)      # GQA
    check_flash(8, 1024, 12, 12, 64, bf16, False, dev, 3)    # non-causal
    check_flash(8, 1024, 12, 12, 32, bf16, True, dev, 4)     # D=32
    check_flash(2, 1024, 8, 8, 96, bf16, True, dev, 8)       # D=96, padded
    # every tile width, padded widths, and D past 128 in 128-wide chunks
    for i, d in enumerate((8, 16, 24, 32, 40, 64, 96, 128, 136, 264)):
        check_flash(2, 200, 4, 2, d, f32, True, dev, 10 + i)  # ragged S
        check_flash(1, 256, 2, 1, d, bf16, False, dev, 30 + i)
        # the tensor-core body on ragged S, GQA, causal and not
        check_flash(2, 200, 4, 2, d, bf16, True, dev, 50 + i)
        check_flash(2, 200, 4, 2, d, bf16, False, dev, 70 + i)
    k2 = check_head(8192, 768, 32768, bf16, dev, 5, timed=True)
    check_head(2048, 768, 32768, f32, dev, 6)
    check_head(100, 96, 1000, f32, dev, 7)                    # ragged
    # the tensor-core body: ragged N and V; vocabs that are not a
    # multiple of the split (40 and 250 tiles of 128 in 8 ranges)
    check_head(100, 96, 1000, bf16, dev, 8)
    check_head(1000, 256, 5000, bf16, dev, 9)
    check_head(1024, 768, 32000, bf16, dev, 10)
    for dtype in (bf16, f32):
        check_head_tie(256, 768, 32768, dtype, dev, 11)
    return k1, k2


# ---------------------------------------------------------------------------
# phase 5: K3 and K4 against their plain versions


def check_flash_bwd(b, s, h, hkv, d, dtype, causal, dev, seed,
                    with_dlse=False, timed=False):
    from singa_tpu_torch.ops import attention as A
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)
    q = randn(b, s, h * d).to(dtype)
    k = randn(b, s, hkv * d).to(dtype)
    v = randn(b, s, hkv * d).to(dtype)
    dout = randn(b, s, h * d).to(dtype)
    with torch.no_grad():
        out, lse = A.flash_attention_packed_lse(q, k, v, h, causal, hkv)
    delta = (dout.float() * out.float()).reshape(b, s, h, d).sum(-1)
    if with_dlse:
        delta = delta - randn(b, s, h)
    args = (q, k, v, dout, lse, delta, h, causal, hkv)
    dq = A.flash_dq(*args)
    dk, dv = A.flash_dkv(*args)
    torch.cuda.synchronize()
    ref = (A.flash_dq_plain(*args), *A.flash_dkv_plain(*args))
    # both sides sum f32 products in another order (in bf16 both round P
    # and dS at the same places before K3's and K4's products): f32
    # outputs agree to
    # ~1e-6 of their magnitude (tolerance 1e-4); a bf16 output may round
    # one ulp (2^-8 relative) apart at its largest magnitude (tol 2^-7)
    rtol = 2 ** -7 if dtype == torch.bfloat16 else 1e-4
    tag = (f"b={b} s={s} h={h} hkv={hkv} d={d} "
           f"{str(dtype).split('.')[-1]} causal={causal}"
           + (" dlse" if with_dlse else ""))
    errs = []
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        top = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        assert torch.isfinite(got.float()).all(), (tag, name)
        assert err <= rtol * top, (tag, name, err, top)
        errs.append((name, err, top))
    res = {"dq": {"max_abs_err": errs[0][1]},
           "dkv": {"max_abs_err": max(errs[1][1], errs[2][1])}}
    if timed:
        from singa_tpu_torch.ops import _kernels
        ptrs = [t.data_ptr() for t in (q, k, v, dout, lse, delta)]
        sizes = (b, s, s, h, hkv, d, int(causal), A.fold_constant(d, dtype),
                 A._DTYPE_CODE[dtype])
        dq_buf, dk_buf, dv_buf = (torch.empty_like(t) for t in (dq, dk, dv))
        res["dq"]["ms"] = graph_ms(lambda: _kernels.launch(
            "flash_dq", *ptrs, dq_buf.data_ptr(), *sizes))
        res["dkv"]["ms"] = graph_ms(lambda: _kernels.launch(
            "flash_dkv", *ptrs, dk_buf.data_ptr(), dv_buf.data_ptr(),
            *sizes))
        res["dq"]["wrapper_ms"] = host_ms(lambda: A.flash_dq(*args))
        res["dkv"]["wrapper_ms"] = host_ms(lambda: A.flash_dkv(*args))
        res["dq"]["plain_ms"] = time_ms(lambda: A.flash_dq_plain(*args), 3, 1)
        res["dkv"]["plain_ms"] = time_ms(lambda: A.flash_dkv_plain(*args),
                                         3, 1)
        lib = (sdpa_backward_ms(q, k, v, dout, h, causal) if h == hkv
               else None)
        res["dq"]["library_ms"] = res["dkv"]["library_ms"] = lib
        pairs = s * (s + 1) // 2 if causal else s * s
        esz = q.element_size()
        stats = 2 * b * s * h * 4                       # lse, delta
        res["dq"]["bound_ms"], res["dq"]["bound_by"] = bound(
            (3 * b * s * h * d + 2 * b * s * hkv * d) * esz + stats,
            6.0 * d * pairs * b * h, dtype)
        res["dkv"]["bound_ms"], res["dkv"]["bound_by"] = bound(
            (2 * b * s * h * d + 4 * b * s * hkv * d) * esz + stats,
            8.0 * d * pairs * b * h, dtype)
    log(f"[kernels] K3/K4 {tag}: "
        + ", ".join(f"max|d{n[1:]}| {e:.3g} (tol {rtol * t:.3g})"
                    for n, e, t in errs)
        + ("".join(f"; {n} kernel {r['ms']:.4f} ms (graph), plain "
                   f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                   f"({r['bound_by']})" for n, r in res.items())
           + f"; SDPA backward {res['dq']['library_ms']} ms"
           if timed else ""))
    if timed:
        log(rate_line("K3 flash_dq", res["dq"], 6.0 * d * pairs * b * h))
        log(rate_line("K4 flash_dkv", res["dkv"], 8.0 * d * pairs * b * h))
        if lib:
            log(f"[kernels] K4 flash_dkv: {res['dkv']['ms'] / lib:.2f}x "
                f"SDPA's whole backward in this run; K3 + K4 "
                f"{(res['dq']['ms'] + res['dkv']['ms']) / lib:.2f}x")
    return res


def sdpa_backward_ms(q, k, v, dout, num_heads, causal):
    """PyTorch's SDPA backward at the same shape: its forward-and-backward
    less its forward (both with autograd recording), each on the card's
    clock by a CUDA-graph replay — the yardstick for K3 and K4 as a
    pair."""
    b, s, hd = q.shape
    d = hd // num_heads

    def heads(x):      # SDPA's own (B, H, S, D) layout, contiguous
        return x.view(b, s, num_heads, d).transpose(1, 2).contiguous()
    qs, ks, vs = (heads(x).requires_grad_() for x in (q, k, v))
    dos = heads(dout)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def fwd():
        return sdpa(qs, ks, vs, is_causal=causal)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qs, ks, vs), dos)
    return graph_ms(fwd_bwd, 10) - graph_ms(fwd, 10)


def phase_flash_bwd(dev):
    bf16, f32 = torch.bfloat16, torch.float32
    bench = check_flash_bwd(8, 1024, 12, 12, 64, bf16, True, dev, 41,
                            timed=True)
    # lm.conf's strided route: one head of 32 per row over B·H = 64 rows
    check_flash_bwd(64, 512, 1, 1, 32, bf16, True, dev, 101, timed=True)
    check_flash_bwd(8, 1024, 12, 4, 64, bf16, True, dev, 42)    # GQA
    check_flash_bwd(8, 1024, 12, 12, 64, bf16, False, dev, 43)  # non-causal
    check_flash_bwd(2, 1024, 12, 12, 64, bf16, True, dev, 44,
                    with_dlse=True)
    # every tile width, padded widths, D past 64 in 64-wide chunks, ragged
    for i, d in enumerate((8, 24, 64, 96, 128, 136, 264)):
        check_flash_bwd(2, 200, 4, 2, d, f32, True, dev, 50 + i)
        check_flash_bwd(2, 200, 4, 2, d, f32, False, dev, 60 + i,
                        with_dlse=True)
        check_flash_bwd(1, 256, 2, 1, d, bf16, True, dev, 70 + i)
        # the tensor-core body of K4 on ragged S, GQA, causal and not
        check_flash_bwd(2, 200, 4, 2, d, bf16, True, dev, 80 + i)
        check_flash_bwd(2, 200, 4, 2, d, bf16, False, dev, 90 + i,
                        with_dlse=True)
    return bench


# ---------------------------------------------------------------------------
# phase 3: the scoring forward


def build(cfg_kw, seq_len):
    from singa_tpu_torch import build_net, transformer_lm
    cfg = transformer_lm(**{**cfg_kw, "seq_len": seq_len})
    return build_net(cfg, "kTest", {"data": {"input": (seq_len,),
                                             "target": (seq_len,)}})


def phase_forward(dev, arrays):
    from singa_tpu_torch import params_from_numpy, synthetic_token_batches
    from singa_tpu_torch.ops import _kernels
    b, s, vocab = BENCH["batchsize"], BENCH["seq_len"], BENCH["vocab_size"]
    net = build(BENCH, s)
    params = params_from_numpy(net, arrays, device=dev)
    batch = next(synthetic_token_batches(b, s, vocab, seed=0))

    def forward(p=params, n=net, x=batch):
        with torch.no_grad():
            return n.apply(p, x, train=False, compute_dtype=torch.bfloat16)

    _kernels.reset_launches()
    _, metrics, _ = forward()
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    loss, prec = float(metrics["loss"]), float(metrics["precision"])
    log(f"[forward] {BENCH['num_layers']}L b={b} s={s}: launches "
        f"{launches}, loss {loss:.5f} (ln V = {math.log(vocab):.5f}), "
        f"precision {prec:.6f}")
    assert math.isfinite(loss) and abs(loss - math.log(vocab)) < 1.0, loss
    assert 0.0 <= prec <= 1.0
    ms = time_ms(forward, 5, 1)
    log(f"[forward] {ms:.3f} ms per forward, {b * s / ms * 1e3:.1f} "
        f"tokens/s")
    profile("forward", forward, ms, top=10)

    # the same weights at 2 layers, batch 2 (N = 2048, still K2-legal):
    # card (kernels) against CPU (plain versions), both bf16 compute, on
    # what the kernels decide: each attention layer's output and K2's
    # per-token lse, label logit and hit on the final hidden state.
    compare_small(dev, arrays)
    phase_eval(dev, arrays)
    return launches


def bench_trainer(dev, graphs, test_steps=0):
    """A Trainer of the bench stack in bf16 (Adam), its steps captured
    (graphs=True, or None: the default, which must capture on the card)
    or eager (False)."""
    from singa_tpu_torch import Trainer, transformer_lm
    cfg = transformer_lm(**BENCH, precision="bfloat16")
    cfg.test_steps = test_steps
    tr = Trainer(cfg, SHAPES, device=dev, graphs=graphs, log_fn=trainer_log)
    assert tr.graphs is (graphs is not False), (tr.graphs, graphs)
    return tr


def phase_eval(dev, arrays):
    """The eval step, `Trainer.evaluate` over EVAL_BATCHES bench batches:
    CUDA-graph replays against eager steps, in turns; the averages must
    be equal to the bit, each step must launch K1 12 times and K2 once."""
    from singa_tpu_torch import params_from_numpy, synthetic_token_batches
    from singa_tpu_torch.ops import _kernels
    b, s, vocab = BENCH["batchsize"], BENCH["seq_len"], BENCH["vocab_size"]
    data = synthetic_token_batches(b, s, vocab, seed=5)
    batches = [next(data) for _ in range(EVAL_BATCHES)]
    runs = {}
    for mode, graphs in (("eager", False), ("graph", True)):
        tr = bench_trainer(dev, graphs, test_steps=EVAL_BATCHES)
        params = params_from_numpy(tr.train_net, arrays, device=dev)

        def evaluate(tr=tr, params=params):
            return tr.evaluate(params, iter(batches), EVAL_BATCHES,
                               tr.test_step)
        _kernels.reset_launches()
        avg = evaluate()        # the graph's warm-up and capture, then replays
        torch.cuda.synchronize()
        assert dict(_kernels.LAUNCHES) == {
            **{k: 0 for k in PER_STEP}, "flash_fwd": 12 * EVAL_BATCHES,
            "head_fwd": EVAL_BATCHES}, (mode, _kernels.LAUNCHES)
        runs[mode] = dict(tr=tr, params=params, evaluate=evaluate, avg=avg,
                          ms=[])
    for r in range(3):
        for mode in (("eager", "graph") if r % 2 == 0 else ("graph", "eager")):
            run = runs[mode]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = run["evaluate"]()
            run["ms"].append((time.perf_counter() - t0) * 1e3 / EVAL_BATCHES)
            assert again == run["avg"], (mode, again, run["avg"])
    for mode, run in runs.items():
        ms = min(run["ms"])
        log(f"[eval] {mode}: Trainer.evaluate over {EVAL_BATCHES} batches "
            f"(b={b}, s={s}; one fetch at the end), per batch "
            + ", ".join(f"{t:.3f}" for t in run["ms"])
            + f" ms in rounds 1-3 (turns), "
            + ", ".join(f"{b * s / t * 1e3:.1f}" for t in run["ms"])
            + " tokens/s; loss {loss:.7f}, precision {precision:.7f}"
            .format(**run["avg"]))
        tr, params = run["tr"], run["params"]
        prof = profile(f"eval_step ({mode})",
                       lambda: tr.test_step(params, batches[0]), ms)
        run["idle"] = prof["idle"]
    same = runs["eager"]["avg"] == runs["graph"]["avg"]
    log(f"[eval] captured and eager averages equal to the bit: {same}; "
        f"idle share eager {runs['eager']['idle']}, graph "
        f"{runs['graph']['idle']}")
    assert same, (runs["eager"]["avg"], runs["graph"]["avg"])


def compare_small(dev, arrays):
    from singa_tpu_torch import params_from_numpy, synthetic_token_batches
    from singa_tpu_torch.ops import head_loss
    bf16, s, vocab = torch.bfloat16, BENCH["seq_len"], BENCH["vocab_size"]
    small = {**BENCH, "num_layers": 2, "batchsize": 2}
    net = build(small, s)
    arr = {k: arrays[k] for k in net.param_specs}
    batch = next(synthetic_token_batches(2, s, vocab, seed=1))
    head = net.layers["loss"]
    w_key = net.param_aliases.get(head.w_key, head.w_key)
    res = {}
    for d in (dev, "cpu"):
        p = params_from_numpy(net, arr, device=d)
        with torch.no_grad():
            _, m, out = net.apply(p, batch, train=False, compute_dtype=bf16)
            h = out["ln_f"].reshape(-1, small["embed_dim"]).contiguous()
            w = p[w_key].to(bf16).contiguous()
            lse, ll, hit = head_loss.head_stats(h, w, out["labels"].reshape(-1))
        res[d] = {"loss": float(m["loss"]), "lse": lse.cpu(), "ll": ll.cpu(),
                  "hit": hit.cpu(), "h": h.float().cpu(), "w": w.float().cpu(),
                  **{n: out[n].float().cpu() for n in ("attn0", "attn1")}}
    card_, cpu = res[dev], res["cpu"]
    # The two sides round bf16 activations after differently ordered f32
    # sums, so they drift apart by a few bf16 ulps over two layers; a
    # wrong kernel moves these outputs by their own magnitude (~1).
    for n in ("attn0", "attn1"):
        gap = (card_[n] - cpu[n]).abs().max().item()
        top = cpu[n].abs().max().item()
        log(f"[forward] 2L b=2 {n}: max|card - cpu| {gap:.3g}, max|cpu| "
            f"{top:.3g} (tol {ATTN_RTOL} * max|cpu|)")
        assert torch.isfinite(card_[n]).all() and gap <= ATTN_RTOL * top, n
    for n, tol in (("lse", LSE_ATOL), ("ll", LL_ATOL)):
        gap = (card_[n] - cpu[n]).abs().max().item()
        log(f"[forward] 2L b=2 K2 per-token {n}: max|card - cpu| {gap:.3g} "
            f"(tol {tol})")
        assert gap <= tol, n
    # a hit may differ only where the CPU's two best logits are closer
    # than the label logits are apart at most
    tie = 2 * (card_["ll"] - cpu["ll"]).abs().max().item()
    flips = (card_["hit"] != cpu["hit"]).nonzero()[:, 0]
    for i in flips.tolist():
        top2 = (cpu["h"][i] @ cpu["w"].T).topk(2).values
        assert (top2[0] - top2[1]).item() <= tie, ("hit flip", i)
    lc, lp = card_["loss"], cpu["loss"]
    log(f"[forward] 2L b=2: card loss {lc:.7f}, cpu loss {lp:.7f} (rtol "
        f"{LOSS_RTOL}); {len(flips)} hit(s) differ, all at near-ties "
        f"(top-2 gap <= {tie:.3g})")
    assert abs(lc - lp) <= LOSS_RTOL * abs(lp), (lc, lp)


# ---------------------------------------------------------------------------
# phase 4: serving, 4a the bucket engine replayed, 4b continuous batching

NEAR_TIE = 1e-4         # a greedy token may differ only below this top-2 gap


def in_turns(runs: dict, rounds: int = 3) -> dict:
    """Host ms of each run's callable, `rounds` times in turns (the order
    flips every round); each callable ends in a fetch to the host."""
    ms = {k: [] for k in runs}
    for r in range(rounds):
        for k in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[k]()
            ms[k].append((time.perf_counter() - t0) * 1e3)
    return ms


def phase_serve(dev, arrays):
    """4a: one CUDA graph per (mode, bucket), captured at warm-up; replays
    against eager calls and the unpadded `generate`."""
    from singa_tpu_torch import (InferenceEngine, ServeSpec, generate,
                                 params_from_numpy)
    from singa_tpu_torch.models.generate import forward_cached, init_cache
    from singa_tpu_torch.ops import _kernels
    vocab = BENCH["vocab_size"]
    net = build(BENCH, BENCH["seq_len"])
    params = params_from_numpy(net, arrays, device=dev)
    rng = np.random.default_rng(7)
    prompts = [list(rng.integers(0, vocab, n))
               for n in (128, 100, 77, 64, 50, 33, 17, 5)]
    bucket, max_new = (8, 128), 32
    greedy_spec = ServeSpec(buckets=(bucket,), max_new_tokens=max_new)
    sampled_spec = ServeSpec(buckets=(bucket,), max_new_tokens=max_new,
                             temperature=0.8, top_k=50, top_p=0.9, seed=3)
    _kernels.reset_launches()
    engines = {}
    for name, spec, graphs in (("graph", greedy_spec, None),
                               ("eager", greedy_spec, False),
                               ("sampled graph", sampled_spec, None),
                               ("sampled graph 2", sampled_spec, None),
                               ("sampled eager", sampled_spec, False)):
        eng = InferenceEngine(net, spec, params, device=dev, log_fn=log,
                              graphs=graphs)
        t0 = time.perf_counter()
        n = eng.warmup(("generate", "predict"))
        assert eng.graphs is (graphs is None) and \
            n == (2 if eng.graphs else 0), (name, eng.graphs, n)
        if eng.graphs:
            log(f"[serve] {name}: warm-up captured {n} graphs "
                      f"(generate and predict at bucket {bucket}) in "
                      f"{time.perf_counter() - t0:.3f} s")
        engines[name] = eng
    captured = {k: e.stats.compiles for k, e in engines.items()}

    out = {k: np.stack(engines[k].answer("generate", prompts))
           for k in ("graph", "eager")}
    assert out["graph"].shape == (8, max_new) and \
        ((out["graph"] >= 0) & (out["graph"] < vocab)).all()
    assert np.array_equal(out["graph"], out["eager"]), \
        "replayed greedy tokens != eager"
    for row, prompt in zip(out["graph"], prompts):
        with torch.no_grad():
            want = generate(net, params, np.array([prompt]), max_new)
        assert np.array_equal(row, want[0].cpu().numpy()), \
            ("padded greedy != unpadded generate", len(prompt))
    ms = in_turns({k: (lambda e=engines[k]: e.answer("generate", prompts))
                   for k in ("eager", "graph")})
    for k in ("eager", "graph"):
        log(f"[serve] 4a greedy bucket {bucket} x {max_new} new "
                  f"tokens, {k}: "
                  + ", ".join(f"{t:.3f}" for t in ms[k])
                  + " ms in rounds 1-3 (turns), "
                  + ", ".join(f"{8 * max_new / t * 1e3:.1f}" for t in ms[k])
                  + " tokens/s (prefill included)")
    log("[serve] 4a replayed greedy tokens equal eager ones and "
              "unpadded generate's")
    for k in ("graph", "eager"):
        prof = profile(f"bucket generate ({k})",
                       lambda e=engines[k]: e.answer("generate", prompts),
                       min(ms[k]))
        log(f"[serve] 4a bucket generate ({k}): idle share "
                  f"{prof['idle']}")

    # predict: next-token log-probs of the padded bucket against
    # forward_cached on each unpadded prompt (f32: rtol/atol 1e-3 covers
    # the reordered sums of shifted RoPE positions and batch shapes), and
    # the replay against the eager call
    lp = {k: engines[k].answer("predict", prompts) for k in ("graph",
                                                            "eager")}
    gap = max(float(np.abs(a - b).max())
              for a, b in zip(lp["graph"], lp["eager"]))
    assert gap <= 1e-5, gap
    for row, prompt in zip(lp["graph"], prompts):
        with torch.no_grad():
            cache = init_cache(net, 1, len(prompt) + 1, torch.float32, dev)
            logits, _ = forward_cached(
                net, params, torch.tensor([prompt], device=dev), cache, 0)
            want = torch.log_softmax(logits[0, -1], dim=-1).cpu().numpy()
        np.testing.assert_allclose(row, want, rtol=1e-3, atol=1e-3)
    log(f"[serve] 4a predict bucket matches forward_cached per "
              f"prompt; replay against eager max|diff| {gap:.3g}")

    sampled = {k: np.stack(engines[k].answer("generate", prompts))
               for k in ("sampled graph", "sampled graph 2",
                         "sampled eager")}
    s0 = sampled["sampled graph"]
    assert s0.shape == (8, max_new) and ((s0 >= 0) & (s0 < vocab)).all()
    assert np.array_equal(s0, sampled["sampled graph 2"]), \
        "seeded sampling differs between two engines"
    assert np.array_equal(s0, sampled["sampled eager"]), \
        "seeded sampling: replay != eager"
    again = np.stack(engines["sampled eager"].answer("generate", prompts))
    assert not np.array_equal(again, s0), "the next call drew the same"
    log(f"[serve] 4a top-k/top-p sampled bucket: {len(set(s0.ravel()))} "
              f"distinct tokens, reproducible from its seed, replay equal "
              f"to eager")
    assert {k: e.stats.compiles for k, e in engines.items()} == captured, \
        "captured after warm-up"
    assert not any(_kernels.LAUNCHES.values()), _kernels.LAUNCHES
    log(f"[serve] 4a no capture after warm-up (compiles "
              f"{captured}); no kernel of K1-K6 on the serving path")


CB_SPEC = dict(cb="on", cb_slots=32, cb_block_len=16, cb_prompt_cap=512,
               max_new_tokens=128, queue_capacity=128,
               request_timeout_s=600.0)
CB_REQUESTS = 96


def cb_traffic(vocab: int):
    """96 greedy requests: prompt lengths uniform in 16-512 and max_new
    in 16-128, from numpy seed 11."""
    rng = np.random.default_rng(11)
    plens = rng.integers(16, 513, CB_REQUESTS)
    max_news = rng.integers(16, 129, CB_REQUESTS)
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in plens]
    return prompts, [int(m) for m in max_news]


def serve_cb(net, params, dev, prompts, max_news, graphs, **spec_kw):
    """Submit every request before `start()` (the order of admission is
    then fixed), serve them all, and return the engine, the results and
    the wall time from `start()` to the last answer."""
    from singa_tpu_torch import InferenceEngine, ServeSpec
    from singa_tpu_torch.serve import ContinuousScheduler
    spec = ServeSpec(**{**CB_SPEC, **spec_kw})
    eng = InferenceEngine(net, spec, params, device=dev, log_fn=log,
                          graphs=graphs)
    n = eng.warmup(("generate",))
    assert n == (2 if graphs is None else 0), n
    sched = ContinuousScheduler(eng, log_fn=log)
    tickets = [sched.submit(p, max_new=m) for p, m in zip(prompts, max_news)]
    t0 = time.perf_counter()
    sched.start()
    try:
        outs = [t.wait(600.0) for t in tickets]
    finally:
        sched.stop()
    wall = time.perf_counter() - t0
    for out, m in zip(outs, max_news):
        assert out["finish"] == "length" and len(out["tokens"]) == m, \
            (out["finish"], len(out["tokens"]), m)
    snap = eng.stats.snapshot()
    assert snap["failed"] == 0 and snap["completed"] == len(prompts), snap
    assert eng.stats.compiles == n, "captured after warm-up"
    return eng, sched, outs, wall


def first_divergence(net, params, dev, prompt, got, want) -> tuple:
    """(index, top-2 logit gap of the contiguous reference there) of the
    first token where a paged answer leaves `generate`'s."""
    from singa_tpu_torch.models.generate import forward_cached, init_cache
    i = next(k for k, (a, b) in enumerate(zip(got, want)) if a != b)
    seq = list(prompt) + list(want[:i])
    with torch.no_grad():
        cache = init_cache(net, 1, len(seq), torch.float32, dev)
        logits, _ = forward_cached(net, params,
                                   torch.tensor([seq], device=dev), cache, 0)
    top2 = logits[0, -1].topk(2).values
    return i, float(top2[0] - top2[1])


def phase_cb(dev, arrays):
    """4b: continuous batching over the paged KV cache, prefill and decode
    step as CUDA graphs, against eager programs and `generate`."""
    from singa_tpu_torch import generate, params_from_numpy
    from singa_tpu_torch.ops import _kernels
    from singa_tpu_torch.serve.kvcache import pool_bytes
    vocab = BENCH["vocab_size"]
    net = build(BENCH, BENCH["seq_len"])
    params = params_from_numpy(net, arrays, device=dev)
    prompts, max_news = cb_traffic(vocab)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _kernels.reset_launches()

    eng, sched, outs, wall = serve_cb(net, params, dev, prompts, max_news,
                                      None)
    spec = eng.spec
    assert (spec.cb_prefill_len, spec.cb_blocks_per_slot,
            spec.cb_pool_blocks) == (512, 40, 1281)
    nbytes = pool_bytes(net, spec.cb_pool_blocks, spec.cb_block_len)
    held = sum(t.numel() * t.element_size()
               for e in eng.cb_pools.values() for t in e.values())
    assert nbytes == held, (nbytes, held)
    ntok = sum(len(o["tokens"]) for o in outs)
    snap = eng.stats.snapshot()
    qw99 = eng.stats.split_quantile("queue_wait", 0.99)
    log(f"[cb] 4b graph: {len(outs)} of {CB_REQUESTS} greedy requests "
              f"served (finish length), 0 failed, {snap['cb_steps']} "
              f"scheduler steps, {ntok} tokens in {wall:.3f} s = "
              f"{ntok / wall:.1f} generated tokens/s; slot occupancy "
              f"{snap['cb_slot_occupancy']}, block utilization "
              f"{snap['cb_block_utilization']}")
    log(f"[cb] 4b graph: request latency p50/p95/p99 "
              f"{snap['p50_latency_ms']}/{snap['p95_latency_ms']}/"
              f"{snap['p99_latency_ms']} ms, queue wait p50/p95/p99 "
              f"{snap['p50_queue_wait_ms']}/{snap['p95_queue_wait_ms']}/"
              f"{qw99 * 1e3:.3f} ms, service p50/p95 "
              f"{snap['p50_service_ms']}/{snap['p95_service_ms']} ms")
    log(f"[cb] 4b pools {nbytes} bytes (pool_bytes = the tensors "
              f"held), {spec.cb_pool_blocks} blocks of {spec.cb_block_len}; "
              f"peak memory "
              f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.3f} GiB "
              f"above the phase's start")

    by_len = sorted(range(CB_REQUESTS), key=lambda i: len(prompts[i]))
    for i in by_len[:4] + by_len[-4:]:
        with torch.no_grad():
            want = generate(net, params, prompts[i][None],
                            max_news[i])[0].tolist()
        got = outs[i]["tokens"]
        if got != want:
            k, gap = first_divergence(net, params, dev, prompts[i], got,
                                      want)
            log(f"[cb] request {i} (plen {len(prompts[i])}) leaves "
                      f"generate at token {k}, where the contiguous "
                      f"reference's top-2 logit gap is {gap:.3g}")
            assert gap <= NEAR_TIE, (i, k, gap)
    log("[cb] 4b the 4 shortest and 4 longest prompts' answers "
              "checked against generate on the unpadded prompt")

    eager, esched, eouts, ewall = serve_cb(net, params, dev, prompts,
                                           max_news, False)
    same = sum(a["tokens"] == b["tokens"] for a, b in zip(outs, eouts))
    log(f"[cb] 4b eager: the same traffic in {ewall:.3f} s = "
              f"{ntok / ewall:.1f} generated tokens/s; {same} of "
              f"{CB_REQUESTS} answers equal the replayed ones")
    assert same == CB_REQUESTS

    # the decode step with every slot active and the prefill, replayed
    # and eager in turns
    s, t = spec.cb_slots, spec.cb_blocks_per_slot
    tables = (1 + np.arange(s * t, dtype=np.int32)).reshape(s, t)
    ntoks = np.full((s,), 320, np.int32)
    toks = np.random.default_rng(12).integers(0, vocab, s).astype(np.int32)
    row = tables[0, :spec.cb_prefill_len // spec.cb_block_len]
    ptoks = prompts[by_len[-1]][None, :spec.cb_prefill_len].copy()
    ptoks = np.pad(ptoks, ((0, 0), (0, spec.cb_prefill_len - ptoks.shape[1])))
    plen = len(prompts[by_len[-1]])

    def decode_steps(e, n=20):
        for _ in range(n):
            e.run_cb_decode(e.params, e.cb_pools, toks, ntoks, tables)

    def prefill(e):
        e.run_cb_prefill(e.params, e.cb_pools, ptoks, plen, row)
    dec = in_turns({"eager": lambda: decode_steps(eager),
                    "graph": lambda: decode_steps(eng)})
    pre = in_turns({"eager": lambda: prefill(eager),
                    "graph": lambda: prefill(eng)})
    for k in ("eager", "graph"):
        log(f"[cb] 4b decode step, {s} slots active at position 320, "
                  f"{k}: " + ", ".join(f"{m / 20:.3f}" for m in dec[k])
                  + " ms per step (3 rounds of 20 in turns, tokens "
                  "fetched each step); prefill at P=512: "
                  + ", ".join(f"{m:.3f}" for m in pre[k]) + " ms")
    for k, e in (("graph", eng), ("eager", eager)):
        prof = profile(f"cb decode step ({k})",
                       lambda e=e: decode_steps(e, 1), min(dec[k]) / 20,
                       top=10)
        log(f"[cb] 4b decode step ({k}): idle share {prof['idle']}")
    profile("cb prefill (graph)", lambda: prefill(eng), min(pre["graph"]))
    # a graph reads the params it was captured over: others must raise
    other = {k: v.clone() for k, v in eng.params.items()}
    try:
        eng.run_cb_decode(other, eng.cb_pools, toks, ntoks, tables)
    except ValueError as e:
        log(f"[cb] 4b a replay over other params raises: {e}")
    else:
        raise AssertionError("the decode graph replayed over other params")
    del other
    assert not any(_kernels.LAUNCHES.values()), _kernels.LAUNCHES
    assert eng.stats.compiles == 2 and eager.stats.compiles == 0
    del eng, sched, eager, esched
    torch.cuda.empty_cache()

    sampled = []
    for _ in range(2):
        e, sch, souts, swall = serve_cb(
            net, params, dev, prompts[:32], max_news[:32], None,
            temperature=0.8, top_k=50, top_p=0.9, seed=3)
        sampled.append([o["tokens"] for o in souts])
        del e, sch
        torch.cuda.empty_cache()
    assert sampled[0] == sampled[1], "seeded cb sampling differs"
    log(f"[cb] 4b sampled traffic (32 requests, temperature 0.8, "
              f"top_k 50, top_p 0.9, seed 3): two runs equal, "
              f"{len({t for r in sampled[0] for t in r})} distinct tokens")


# ---------------------------------------------------------------------------
# phase 6: gradients, card against CPU

# of each gradient's largest magnitude on the CPU, about 4x the worst gap
# an H100 showed (0.0126, attn1/wk): bf16 activations are rounded after
# differently ordered f32 sums on the two sides
GRAD_RTOL = 0.05
SHAPES = {"data": {"input": (BENCH["seq_len"],),
                   "target": (BENCH["seq_len"],)}}
PER_STEP = {"flash_fwd": 12, "flash_dq": 12, "flash_dkv": 12, "head_fwd": 1,
            "lrn_fwd": 0, "lrn_bwd": 0}


def small_cfg(**kw):
    from singa_tpu_torch import transformer_lm
    return transformer_lm(**{**BENCH, "num_layers": 2, "batchsize": 2,
                             "precision": "bfloat16", **kw})


def start(trainer, arrays, dev):
    from singa_tpu_torch import params_from_numpy
    net = trainer.train_net
    params = params_from_numpy(net, {k: arrays[k] for k in net.param_specs},
                               device=dev)
    return params, trainer.updater.init(params)


def phase_grads(dev, arrays):
    from singa_tpu_torch import Trainer, synthetic_token_batches
    from singa_tpu_torch.ops import _kernels
    batch = next(synthetic_token_batches(2, BENCH["seq_len"],
                                         BENCH["vocab_size"], seed=1))
    res = {}
    for d in (dev, "cpu"):
        tr = Trainer(small_cfg(), SHAPES, device=d, log_fn=trainer_log)
        params, _ = start(tr, arrays, d)
        _kernels.reset_launches()
        t0 = time.perf_counter()
        metrics, grads = tr.gradients(params, batch)
        if d != "cpu":
            torch.cuda.synchronize()
            launches = dict(_kernels.LAUNCHES)
        missing = sorted(k for k, g in grads.items() if g is None)
        log(f"[grads] 2L b=2 on {d}: loss {float(metrics['loss']):.7f}, "
            f"{len(grads)} params, none without a gradient: {not missing}"
            f" ({time.perf_counter() - t0:.1f} s)")
        assert not missing, (d, missing)
        res[d] = {k: g.float().cpu() for k, g in grads.items()}
    log(f"[grads] card launches {launches}")
    # two attention layers and the head
    assert launches == {"flash_fwd": 2, "flash_dq": 2, "flash_dkv": 2,
                        "head_fwd": 1, "lrn_fwd": 0, "lrn_bwd": 0}, launches
    worst = 0.0
    for name in sorted(res["cpu"]):
        want, got = res["cpu"][name], res[dev][name]
        top = want.abs().max().item()
        gap = (got - want).abs().max().item()
        worst = max(worst, gap / top)
        log(f"[grads]   {name}: max|card - cpu| {gap:.3g}, max|cpu| "
            f"{top:.3g}, ratio {gap / top:.3g} (tol {GRAD_RTOL})")
        assert torch.isfinite(got).all() and gap <= GRAD_RTOL * top, name
    log(f"[grads] worst ratio {worst:.3g}")


# ---------------------------------------------------------------------------
# phase 7: training the bench stack, then checkpoints

TRAIN_STEPS = 20
EXACT_STEPS = 10        # eager against replay, from one copied start
ROUNDS, ROUND_STEPS = 3, 10
# what a profiled replay of the train step must hold, by kernel name
PROFILED_PER_STEP = {"flash_fwd_mma_kernel": 12, "flash_dq_mma_kernel": 12,
                     "flash_dkv_mma_kernel": 12, "head_fwd_mma_kernel": 1}
# the mean loss of the last 5 steps must sit this far (nats) below the
# first step's
LOSS_MARGIN = 0.1


def phase_train(dev, arrays):
    from singa_tpu_torch import synthetic_token_batches
    from singa_tpu_torch.ops import _kernels
    from singa_tpu_torch.ops.head_loss import (head_stats, logits_f32,
                                               xent_backward)
    b, s, vocab = BENCH["batchsize"], BENCH["seq_len"], BENCH["vocab_size"]
    tr = bench_trainer(dev, None)
    params, opt = start(tr, arrays, dev)
    data = synthetic_token_batches(b, s, vocab, seed=0)
    batches = [next(data) for _ in range(TRAIN_STEPS)]
    losses, step_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    for step, batch in enumerate(batches):
        before = dict(_kernels.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = tr.train_step(params, opt, batch, step)
        losses.append(float(m["loss"]))     # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per = {k: _kernels.LAUNCHES[k] - before[k] for k in before}
        assert per == PER_STEP, (step, per)
        assert math.isfinite(losses[-1]), losses
    launches = dict(_kernels.LAUNCHES)
    graphs = tr._train_graph._graphs
    captured = [g.launches for g in graphs.values()]
    assert captured == [{k: v for k, v in PER_STEP.items() if v}], captured
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    tail = sum(losses[-5:]) / 5
    ms = sum(step_ms[2:]) / len(step_ms[2:])
    log(f"[train] {BENCH['num_layers']}L b={b} s={s} Adam, CUDA-graph "
        f"replays: {TRAIN_STEPS} steps, launches {launches} (the capture "
        f"recorded {captured[0]} per replay); loss first {losses[0]:.5f}, "
        f"mean of last 5 {tail:.5f} (must be < first - {LOSS_MARGIN}); "
        f"losses " + " ".join(f"{x:.4f}" for x in losses))
    assert tail < losses[0] - LOSS_MARGIN, losses
    log(f"[train] step {ms:.3f} ms (mean of steps 2..{TRAIN_STEPS - 1}, "
        f"host clock, synchronised; step 0 with warm-up and capture "
        f"{step_ms[0]:.1f}, step 1 {step_ms[1]:.1f} ms), "
        f"{b * s / ms * 1e3:.1f} tokens/s; peak device memory "
        f"{peak_gib:.2f} GiB")

    # the step's split on the card's clock (CUDA events between the
    # phases of an eager step, the second of two: the first on this
    # stream pays its first-call setup): forward with autograd
    # recording, backward, update; then the head's backward alone
    batch = batches[-1]
    names = sorted(params)
    for step in (TRAIN_STEPS, TRAIN_STEPS + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        for p in params.values():
            p.requires_grad_(True)
        ev[0].record()
        loss, _, _ = tr.train_net.apply(params, batch, train=True,
                                        compute_dtype=torch.bfloat16)
        ev[1].record()
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        ev[2].record()
        for p in params.values():
            p.requires_grad_(False)
        tr.updater.update(step, dict(zip(names, grads)), params, opt,
                          tr.multipliers)
        ev[3].record()
        torch.cuda.synchronize()
    fwd_ms, bwd_ms, upd_ms = (ev[i].elapsed_time(ev[i + 1])
                              for i in range(3))
    g = torch.Generator(device=dev).manual_seed(9)
    h = torch.randn((b * s, BENCH["embed_dim"]), generator=g,
                    device=dev).to(torch.bfloat16)
    w = params["embed/embedding"].to(torch.bfloat16)
    labels = torch.randint(0, vocab, (b * s,), generator=g, device=dev)
    lse = head_stats(h, w, labels)[0]
    coef = torch.tensor(1.0 / (b * s), device=dev)
    head_ms = time_ms(lambda: xent_backward(h, w, labels, lse, coef, 4096),
                      3, 1)
    # the head backward's f32 logits for one chunk: the bf16 product
    # with an f32 output (what the port takes) against upcast operands
    hc = h[:4096]
    out_ms = time_ms(lambda: logits_f32(hc, w), 5, 1)
    up_ms = time_ms(lambda: hc.float() @ w.float().T, 5, 1)
    log(f"[train] head backward logits per 4096-token chunk: bf16 product "
        f"with f32 output {out_ms:.3f} ms, f32 upcast product {up_ms:.3f} "
        f"ms")
    log(f"[train] split of an eager step (CUDA events): forward "
        f"{fwd_ms:.3f} ms, backward {bwd_ms:.3f} ms, update (foreach) "
        f"{upd_ms:.3f} ms; the head's backward alone {head_ms:.3f} ms")
    # the kernels inside one replay, by name
    prof = profile("train_step (replay)", lambda: tr.train_step(
        params, opt, batch, TRAIN_STEPS + 2), ms, top=16)
    check_replay_profile(prof, PROFILED_PER_STEP)
    return launches


def check_replay_profile(prof, want) -> None:
    """The kernels that the profiler saw inside one replay, counted by
    name, must be the launches the capture recorded; where it saw no
    device time, the Python count against the capture's delta (checked
    by the caller) stands alone."""
    if not prof["counts"]:
        log("[train] the profiler saw no kernels inside the replay: the "
            "launch counts rest on the capture's recorded delta")
        return
    got = count_named(prof["counts"], want)
    log(f"[train] kernels in one profiled replay, by name: {got}")
    assert got == want, (got, want)


def lm_state_gaps(a, b) -> dict:
    """Tensor name -> max |a - b| for every param and optimizer slot of
    two (params, opt_state) pairs that differ."""
    (pa, oa), (pb, ob) = a, b
    pairs = [(f"params/{n}", pa[n], pb[n]) for n in pa]
    pairs += [(f"{sl}/{n}", oa[sl][n], ob[sl][n]) for sl in oa
              for n in oa[sl]]
    return {n: (x.float() - y.float()).abs().max().item()
            for n, x, y in pairs if not torch.equal(x, y)}


def phase_graphs(dev, arrays):
    """Eager steps against CUDA-graph replays of the bench stack: from one
    copied start, EXACT_STEPS steps each must leave params and Adam state
    equal under torch.equal; then ROUNDS rounds of ROUND_STEPS steps in
    turns (tokens/s, per-step sync as run(scan_chunk=0)); train_steps
    with one sync at the end; a profiled step of each; peak memory; and
    the two must still be equal."""
    from singa_tpu_torch import synthetic_token_batches
    from singa_tpu_torch.ops import _kernels
    b, s, vocab = BENCH["batchsize"], BENCH["seq_len"], BENCH["vocab_size"]
    data = synthetic_token_batches(b, s, vocab, seed=3)
    batches = [next(data) for _ in range(EXACT_STEPS
                                         + ROUNDS * ROUND_STEPS)]
    runs = {}
    for mode, graphs in (("eager", False), ("graph", True)):
        tr = bench_trainer(dev, graphs)
        params, opt = start(tr, arrays, dev)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launches()
        for i in range(EXACT_STEPS):
            before = dict(_kernels.LAUNCHES)
            params, opt, _ = tr.train_step(params, opt, batches[i], i)
            per = {k: _kernels.LAUNCHES[k] - before[k] for k in before}
            assert per == PER_STEP, (mode, i, per)
        torch.cuda.synchronize()
        runs[mode] = dict(
            tr=tr, state=(params, opt), ms=[], step=EXACT_STEPS,
            peak=(torch.cuda.max_memory_allocated() - base) / 2 ** 30,
            held=(torch.cuda.memory_allocated() - base) / 2 ** 30)
    gaps = lm_state_gaps(runs["eager"]["state"], runs["graph"]["state"])
    log(f"[graphs] {EXACT_STEPS} eager steps and {EXACT_STEPS} replays "
        f"from one copied start: params and Adam state equal under "
        f"torch.equal: {not gaps}")
    for name, gap in sorted(gaps.items(), key=lambda kv: -kv[1]):
        log(f"[graphs]   {name}: max|graph - eager| {gap:.3g}")
    assert not gaps, f"{len(gaps)} tensors differ"

    def steps(mode, n):
        run = runs[mode]
        params, opt = run["state"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            k = run["step"]
            params, opt, m = run["tr"].train_step(
                params, opt, batches[k % len(batches)], k)
            float(m["loss"])        # one fetch a step, as run() drains
            run["step"] += 1
        run["state"] = (params, opt)
        return (time.perf_counter() - t0) * 1e3 / n

    for r in range(ROUNDS):
        for mode in (("eager", "graph") if r % 2 == 0 else ("graph", "eager")):
            runs[mode]["ms"].append(steps(mode, ROUND_STEPS))
    for mode, run in runs.items():
        params, opt = run["state"]
        stacked = {"data": {f: torch.from_numpy(np.stack(
            [bt["data"][f] for bt in batches[:ROUND_STEPS]])).to(dev)
            for f in ("input", "target")}}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, ms = run["tr"].train_steps(params, opt, stacked,
                                                run["step"], ROUND_STEPS,
                                                stacked=True)
        ms["loss"].cpu()            # the one sync
        run["scan_ms"] = (time.perf_counter() - t0) * 1e3 / ROUND_STEPS
        run["step"] += ROUND_STEPS
        run["state"] = (params, opt)
        wall = min(run["ms"])
        prof = profile(f"train_step ({mode})", lambda: steps(mode, 1), wall,
                       top=6)
        run["busy"], run["idle"] = prof["busy_ms"], prof["idle"]
        if mode == "graph":
            check_replay_profile(prof, PROFILED_PER_STEP)
    for mode, run in runs.items():
        log(f"[graphs] {mode}: step "
            + ", ".join(f"{t:.3f}" for t in run["ms"])
            + f" ms in rounds 1-{ROUNDS} of {ROUND_STEPS} (turns, host "
            f"clock, one fetch a step), "
            + ", ".join(f"{b * s / t * 1e3:.1f}" for t in run["ms"])
            + f" tokens/s; train_steps({ROUND_STEPS}) with one sync "
            f"{run['scan_ms']:.3f} ms a step, "
            f"{b * s / run['scan_ms'] * 1e3:.1f} tokens/s; profiled step "
            f"busy {run['busy']} ms, idle share {run['idle']}; peak "
            f"{run['peak']:.2f} GiB above the {EXACT_STEPS} steps' start, "
            f"{run['held']:.2f} GiB still allocated after them")
    gaps = lm_state_gaps(runs["eager"]["state"], runs["graph"]["state"])
    log(f"[graphs] after {runs['graph']['step']} steps each: equal under "
        f"torch.equal: {not gaps}")
    assert runs["eager"]["step"] == runs["graph"]["step"]
    assert not gaps, sorted(gaps.items(), key=lambda kv: -kv[1])[:8]


def phase_resume(dev, arrays):
    """k steps with checkpoint_frequency k, resume into a fresh, captured
    Trainer and continue: bit-for-bit the params and state of an
    uninterrupted run (the kernels use no atomics; cuBLAS is
    deterministic on one stream).  Every trainer replays CUDA graphs; the
    uninterrupted one runs in chunks (scan_chunk), and the resumed one
    was captured over other params first, which resume's are copied
    into."""
    import shutil
    import tempfile
    from singa_tpu_torch import Trainer, synthetic_token_batches
    k, total, bsz = 3, 6, 2

    def trainer(steps):
        cfg = small_cfg(batchsize=bsz)
        cfg.train_steps, cfg.checkpoint_frequency = steps, k
        tr = Trainer(cfg, SHAPES, device=dev, log_fn=trainer_log)
        assert tr.graphs
        return tr

    def data(skip=0):
        it = synthetic_token_batches(bsz, BENCH["seq_len"],
                                     BENCH["vocab_size"], seed=2)
        for _ in range(skip):
            next(it)
        return it

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    ws = tempfile.mkdtemp(prefix="chip_smoke_ckpt_",
                          dir=os.path.join(REPO, "build"))
    try:
        whole = trainer(total)
        pa, oa, _ = whole.run(*start(whole, arrays, dev), data(),
                              scan_chunk=4)
        first = trainer(k)
        first.run(*start(first, arrays, dev), data(), workspace=ws)
        again = trainer(total)
        p0, o0 = start(again, arrays, dev)
        again.train_step(p0, o0, next(data(total)), 0)     # captures
        pc, oc, at = again.resume(p0, o0, ws)
        assert at == k, at
        pc, oc, _ = again.run(pc, oc, data(k), start_step=k)
        assert pc is p0 and oc is o0, "resumed tensors were not copied in"
    finally:
        shutil.rmtree(ws)
    same_p = all(torch.equal(pa[n], pc[n]) for n in pa)
    same_o = all(torch.equal(oa[sl][n], oc[sl][n]) for sl in oa
                 for n in oa[sl])
    log(f"[resume] 2L b={bsz}, CUDA-graph replays: {k} steps, snapshot, a "
        f"captured Trainer resumes at step {at} (copied into its graph's "
        f"params) and runs to {total}: params equal an uninterrupted "
        f"chunked run bit for bit: {same_p}; optimizer state: {same_o}")
    assert same_p and same_o


# ---------------------------------------------------------------------------
# phase 8: K5 and K6 against their plain versions

ALEX_SHAPES = {"norm1": (1024, 32, 32, 64), "norm2": (1024, 16, 16, 192)}


def _ulp_bf16(top: float) -> float:
    return 2.0 ** (math.floor(math.log2(top)) - 7)


def lrn_library_ms(a, g, local_size, alpha, beta, knorm):
    """`F.local_response_norm` on the NCHW view of NHWC `a` (relu(x) when
    the kernels fuse the ReLU): its forward, and its forward-and-backward
    less its forward (autograd recording in both) — the yardstick for K5
    and for K6."""
    lrn_f = torch.nn.functional.local_response_norm
    an = a.permute(0, 3, 1, 2).detach().requires_grad_()
    gn = g.permute(0, 3, 1, 2)

    def fwd():
        return lrn_f(an, local_size, alpha, beta, knorm)

    def fwd_bwd():
        torch.autograd.grad(fwd(), an, gn)
    f = time_ms(fwd, 10)
    return f, time_ms(fwd_bwd, 10) - f


def lrn_route(x, c: int) -> str:
    """The route the LRN kernels' C entries take (csrc/lrn_common.cuh):
    8-channel groups on 16 bytes go the vector route."""
    return ("vector" if c % 8 == 0 and x.data_ptr() % 16 == 0
            else "general")


def check_lrn(shape, dtype, local_size, alpha, beta, relu, dev, seed,
              scale=1.0, timed=False, offset=0):
    """K5 and K6 against their plain versions on x of `shape`; `offset`
    elements before x in its storage move its start off 16 bytes."""
    from singa_tpu_torch.ops import lrn as L
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = math.prod(shape)
    x = (scale * torch.randn(n + offset, generator=gen, device=dev)
         ).to(dtype)[offset:].view(shape)
    g = torch.randn(shape, generator=gen, device=dev).to(dtype)
    args = (local_size, alpha, beta, 1.0, relu)
    y, dx = L.lrn_fwd(x, *args), L.lrn_bwd(x, g, *args)
    torch.cuda.synchronize()
    ref_y, ref_dx = L.lrn_fwd_plain(x, *args), L.lrn_bwd_plain(x, g, *args)
    route = lrn_route(x, shape[-1])
    tag = (f"{tuple(shape)} {str(dtype).split('.')[-1]} L={local_size} "
           f"alpha={alpha} beta={beta} relu={relu} {route} route")
    errs = {}
    for name, got, want in (("lrn_fwd", y, ref_y), ("lrn_bwd", dx, ref_dx)):
        top = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        # f32: the same f32 steps, another sqrt/pow: 1e-5 of the largest
        # |value|; bf16: the same f32 values rounded, one ulp apart at most
        tol = 1e-5 * top if dtype == torch.float32 else _ulp_bf16(top)
        assert torch.isfinite(got.float()).all(), (tag, name)
        assert err <= tol, (tag, name, err, tol)
        errs[name] = {"max_abs_err": err}
        log(f"[lrn] {name} {tag}: max err {err:.3g} (tol {tol:.3g}, "
            f"max|value| {top:.3g})")
    if timed:
        from singa_tpu_torch.ops import _kernels
        esz, c = x.element_size(), shape[-1]
        npix = n // c
        a = torch.relu(x) if relu else x
        lib_f, lib_b = lrn_library_ms(a, g, local_size, alpha, beta, 1.0)
        y_buf, dx_buf = torch.empty_like(x), torch.empty_like(x)
        code = L._DTYPE_CODE[dtype]
        for name, launch, fn, plain, nbytes, ops, lib in (
                ("lrn_fwd", lambda: _kernels.launch(
                    "lrn_fwd", x.data_ptr(), y_buf.data_ptr(), npix, c,
                    *args[:4], int(relu), code),
                 lambda: L.lrn_fwd(x, *args),
                 lambda: L.lrn_fwd_plain(x, *args), 2 * n * esz,
                 (local_size + 7) * n, lib_f),
                ("lrn_bwd", lambda: _kernels.launch(
                    "lrn_bwd", x.data_ptr(), g.data_ptr(), dx_buf.data_ptr(),
                    npix, c, *args[:4], int(relu), code),
                 lambda: L.lrn_bwd(x, g, *args),
                 lambda: L.lrn_bwd_plain(x, g, *args), 3 * n * esz,
                 (2 * local_size + 13) * n, lib_b)):
            r = errs[name]
            r["ms"] = graph_ms(launch)
            r["events_ms"] = time_ms(fn, 20)
            r["wrapper_ms"] = host_ms(fn)
            r["plain_ms"] = time_ms(plain, 5, 1)
            r["library_ms"] = lib
            # f32 arithmetic outside the tensor cores
            r["bound_ms"], r["bound_by"] = bound(nbytes, ops, torch.float32)
            log(f"[lrn] {name} {tag}: kernel {r['ms']:.4f} ms (graph), "
                f"{r['events_ms']:.4f} ms (CUDA events around the wrapper), "
                f"plain {r['plain_ms']:.4f} ms, F.local_response_norm"
                f"{' on relu(x)' if relu else ''} {lib:.4f} ms, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
            log(f"[kernels] {'K5' if name == 'lrn_fwd' else 'K6'} {name} "
                f"{tuple(shape)}: {nbytes / r['ms'] / 1e9:.3f} TB/s, "
                f"{r['bound_ms'] / r['ms']:.3f} of the bound "
                f"({r['bound_by']}); wrapper {r['wrapper_ms']:.4f} ms per "
                f"call on the host; F.local_response_norm is "
                f"{lib / r['ms']:.2f}x the kernel in this run")
    return errs


def phase_lrn(dev):
    """Returns each kernel's record at norm1 (the larger shape)."""
    bf16, f32 = torch.bfloat16, torch.float32
    timed = {}
    for name, shape in ALEX_SHAPES.items():
        # inputs ~30: the window sum moves n = 1 + (alpha/L)·s visibly
        timed[name] = check_lrn(shape, bf16, 5, 1e-4, 0.75, True, dev, 80,
                                scale=30.0, timed=True)
        check_lrn(shape, f32, 5, 1e-4, 0.75, True, dev, 81, scale=30.0)
    for dtype in (f32, bf16):
        check_lrn((3, 7, 5, 13), dtype, 3, 1.0, 0.5, False, dev, 82)
        # C > 2048: one pixel per block on both routes
        check_lrn((2, 3, 3, 3000), dtype, 5, 1.0, 0.75, True, dev, 83)
        # the vector route's edges: one thread per pixel (C=8); the
        # widest unrolled window (L=9) on two threads a pixel; past 2048
        # channels (C=2056, runtime loops); a runtime beta and window
        check_lrn((4, 5, 5, 8), dtype, 5, 1.0, 0.75, True, dev, 84)
        check_lrn((4, 5, 5, 16), dtype, 9, 1.0, 0.75, False, dev, 85)
        check_lrn((2, 3, 3, 2056), dtype, 7, 1.0, 0.75, True, dev, 86)
        check_lrn((5, 4, 4, 24), dtype, 11, 1.0, 0.5, True, dev, 87)
        # pixel counts that are not a multiple of the tile (32 pixels at
        # C=64, 10 at C=192), over more tiles than the grid has blocks
        check_lrn((1000, 7, 7, 64), dtype, 5, 1e-4, 0.75, True, dev, 88,
                  scale=30.0)
        check_lrn((999, 5, 5, 192), dtype, 7, 1.0, 0.75, False, dev, 89)
        # a view one element into its storage: off 16 bytes, so the
        # general route runs at a vector route's C
        check_lrn((8, 6, 6, 64), dtype, 5, 1.0, 0.75, True, dev, 90,
                  offset=1)
    return timed["norm1"]


# ---------------------------------------------------------------------------
# phase 9: AlexNet-CIFAR10, the slice's main path

ALEX_CONF = os.path.join(REPO, "examples", "cifar10", "alexnet.conf")
RGB_SHAPES = {"data": {"pixel": (3, 32, 32), "label": ()}}
ALEX_STEPS = 20
ALEX_BATCH = 1024   # alexnet.conf's own batchsize
ALEX_PER_STEP = {"flash_fwd": 0, "head_fwd": 0, "flash_dq": 0,
                 "flash_dkv": 0, "lrn_fwd": 2, "lrn_bwd": 2}
# card against CPU at batch 4, f32, train=False: of each gradient's
# largest magnitude on the CPU, about 5x the worst gap an H100 showed
# (conv1/weight 0.0035: cuDNN and the CPU sum the first layers' small,
# cancelling gradients in another order)
ALEX_GRAD_RTOL = 0.02
ALEX_LOSS_RTOL = 1e-5
# the mean loss of the last 5 steps must sit this far (nats) below the
# first step's
ALEX_MARGIN = 0.1


def alexnet_trainer(dev, precision, test_steps=0, logs=None):
    from singa_tpu_torch import Trainer, load_model_config
    cfg = load_model_config(ALEX_CONF)
    cfg.precision = precision
    cfg.test_steps = test_steps
    return Trainer(cfg, RGB_SHAPES, device=dev,
                   log_fn=(logs if logs is not None else []).append)


def phase_alexnet(dev):
    from singa_tpu_torch import (numpy_params, params_from_numpy,
                                 synthetic_image_batches)
    from singa_tpu_torch.ops import _kernels
    logs = []
    tr = alexnet_trainer(dev, "bfloat16", test_steps=1, logs=logs)
    # dropout and the RGB mirror draw per step from host-seeded
    # generators: graphs=None must pick eager steps, and say why
    why = [m for m in logs if "eagerly" in m]
    log(f"[alexnet] graphs=None: graphs {tr.graphs}; {why}")
    assert tr.graphs is False and len(why) == 1, (tr.graphs, logs)
    b = tr.train_net.layers["data"].batchsize
    assert b == ALEX_BATCH, b
    arrays = numpy_params(tr.train_net, seed=0)
    params = params_from_numpy(tr.train_net, arrays, device=dev)
    opt = tr.updater.init(params)
    data = synthetic_image_batches(b, (3, 32, 32), seed=0, stream_seed=1)
    batches = [next(data) for _ in range(ALEX_STEPS + 2)]
    losses, step_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    for step in range(ALEX_STEPS):
        before = dict(_kernels.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = tr.train_step(params, opt, batches[step], step)
        losses.append(float(m["loss"]))     # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per = {k: _kernels.LAUNCHES[k] - before[k] for k in before}
        assert per == ALEX_PER_STEP, (step, per)
        assert math.isfinite(losses[-1]), losses
    stacked = {"data": {k: np.stack([bt["data"][k] for bt in batches[-2:]])
                        for k in ("pixel", "label")}}
    params, opt, ms2 = tr.train_steps(params, opt, stacked, ALEX_STEPS, 2,
                                      stacked=True)
    losses += [float(v) for v in ms2["loss"]]
    launches = dict(_kernels.LAUNCHES)
    n_all = ALEX_STEPS + 2
    assert launches == {k: v * n_all for k, v in ALEX_PER_STEP.items()}, \
        launches
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = sum(step_ms[2:]) / len(step_ms[2:])
    log(f"[alexnet] alexnet.conf b={b} bf16 kSGD: {n_all} steps "
        f"({ALEX_STEPS} train_step + 2 train_steps), launches {launches}; "
        f"losses " + " ".join(f"{x:.4f}" for x in losses))
    check_alexnet_loss(losses)
    log(f"[alexnet] step {ms:.3f} ms (mean of steps 2..{ALEX_STEPS - 1}, "
        f"host clock, synchronised; steps 0-1 {step_ms[0]:.1f}, "
        f"{step_ms[1]:.1f} ms), {b / ms * 1e3:.1f} images/s; peak device "
        f"memory {peak_gib:.2f} GiB")

    # the step's split on the card's clock, as phase 7
    batch = batches[-1]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    names = sorted(params)
    for p in params.values():
        p.requires_grad_(True)
    ev[0].record()
    loss, _, _ = tr.train_net.apply(params, batch, train=True,
                                    compute_dtype=torch.bfloat16,
                                    rng=tr.seed, step=n_all)
    ev[1].record()
    grads = torch.autograd.grad(loss, [params[n] for n in names])
    ev[2].record()
    for p in params.values():
        p.requires_grad_(False)
    tr.updater.update(n_all, dict(zip(names, grads)), params, opt,
                      tr.multipliers)
    ev[3].record()
    torch.cuda.synchronize()
    fwd_ms, bwd_ms, upd_ms = (ev[i].elapsed_time(ev[i + 1])
                              for i in range(3))
    log(f"[alexnet] split (CUDA events): forward {fwd_ms:.3f} ms, backward "
        f"{bwd_ms:.3f} ms, update {upd_ms:.3f} ms")
    profile("alexnet_train_step", lambda: tr.train_step(
        params, opt, batch, n_all + 1), ms, top=12)

    # the eval step (scoring forward) through Trainer.evaluate
    _kernels.reset_launches()
    avg = tr.evaluate(params, iter(batches[:1]), 1, tr.test_step)
    torch.cuda.synchronize()
    assert dict(_kernels.LAUNCHES) == {**{k: 0 for k in ALEX_PER_STEP},
                                       "lrn_fwd": 2}, _kernels.LAUNCHES
    assert math.isfinite(avg["loss"]) and 0.0 <= avg["precision"] <= 1.0
    n_eval = 10

    def evaluate():
        return tr.evaluate(params, iter(batches[:n_eval]), n_eval,
                           tr.test_step)
    evaluate()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evaluate()
    eval_ms = (time.perf_counter() - t0) * 1e3 / n_eval
    log(f"[alexnet] eval step (Trainer.evaluate, {n_eval} batches, host "
        f"clock, metrics on the host): {eval_ms:.3f} ms, "
        f"{b / eval_ms * 1e3:.1f} images/s; loss {avg['loss']:.5f}, "
        f"precision {avg['precision']:.5f}")
    profile("alexnet_eval_step", lambda: tr.test_step(params, batches[0]),
            eval_ms)
    compare_alexnet(dev, arrays)
    return launches


def check_alexnet_loss(losses):
    """The mean loss of the last 5 steps must sit ALEX_MARGIN nats below
    the first step's.  At this config's lr (0.01, momentum 0.9, fc
    biases 1.0) the loss first climbs for a few steps, then comes down."""
    top = max(losses)
    tail = sum(losses[-5:]) / 5
    log(f"[alexnet] loss first {losses[0]:.5f}, peak {top:.5f} at step "
        f"{losses.index(top)}, mean of last 5 {tail:.5f} (must be < first "
        f"- {ALEX_MARGIN}); ln 10 = {math.log(10):.5f}")
    assert tail < losses[0] - ALEX_MARGIN, losses


def compare_alexnet(dev, arrays):
    """The training weights at full width, batch 4, f32, train=False
    (no dropout, no mirror; K5/K6 on the card, their plain versions on
    the CPU): loss and every gradient, card against CPU."""
    from singa_tpu_torch import params_from_numpy, synthetic_image_batches
    batch = next(synthetic_image_batches(4, (3, 32, 32), seed=3))
    res = {}
    for d in (dev, "cpu"):
        tr = alexnet_trainer(d, "float32")
        net = tr.train_net
        params = params_from_numpy(net, arrays, device=d)
        for p in params.values():
            p.requires_grad_(True)
        loss, _, _ = net.apply(params, batch, train=False)
        names = sorted(params)
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        res[d] = (float(loss.detach()), {n: g.float().cpu()
                                for n, g in zip(names, grads)})
    (lc, gc), (lp, gp) = res[dev], res["cpu"]
    log(f"[alexnet] b=4 f32 card loss {lc:.7f}, cpu loss {lp:.7f} (rtol "
        f"{ALEX_LOSS_RTOL})")
    assert abs(lc - lp) <= ALEX_LOSS_RTOL * abs(lp), (lc, lp)
    worst = 0.0
    for name in sorted(gp):
        top = gp[name].abs().max().item()
        gap = (gc[name] - gp[name]).abs().max().item()
        ratio = gap / top if top > 0 else gap
        worst = max(worst, ratio)
        log(f"[alexnet]   {name}: max|card - cpu| {gap:.3g}, max|cpu| "
            f"{top:.3g}, ratio {ratio:.3g} (tol {ALEX_GRAD_RTOL})")
        assert torch.isfinite(gc[name]).all() and ratio <= ALEX_GRAD_RTOL, \
            name
    log(f"[alexnet] card against CPU: worst gradient ratio {worst:.3g}")


# ---------------------------------------------------------------------------
# phase 10: examples/transformer/lm.conf, uncut: kMoE, training, beam
# search and serving

LM_CONF = os.path.join(REPO, "examples", "transformer", "lm.conf")
LM_SEQ = 512
LM_SHAPES = {"data": {"input": (LM_SEQ,), "target": (LM_SEQ,)}}
# two attention layers on the strided flash route, a kLMHead ->
# kSoftmaxLoss head (no K2)
LM_PER_STEP = {"flash_fwd": 2, "flash_dq": 2, "flash_dkv": 2, "head_fwd": 0,
               "lrn_fwd": 0, "lrn_bwd": 0}
LM_PROFILED = {"flash_fwd_mma_kernel": 2, "flash_dq_mma_kernel": 2,
               "flash_dkv_mma_kernel": 2, "head_fwd_mma_kernel": 0}
LM_EXACT, LM_ROUNDS, LM_ROUND_STEPS = 10, 3, 10
LM_BATCHES = 10         # synthetic batches, repeated
# card against CPU, bf16.  An H100 showed: 12 of 4096 tokens routed to
# another top-2 set (their router input differs by bf16 ulps); outputs
# within 0.0023 (attn0), 0.0042 (attn1) and 0.0099 (moe1, tokens routed
# alike) of their largest magnitudes; loss 1.5e-5 apart
LM_ROUTED_ALIKE = 0.98  # share of tokens with the same experts and drops
LM_LOSS_RTOL = 1e-3
LM_OUT_RTOL = 2 ** -5   # of each layer output's largest magnitude
LM_GRAD_RTOL = 0.05     # of each gradient's largest magnitude, as phase 6


def lm_trainer(dev, graphs):
    from singa_tpu_torch import Trainer, load_model_config
    cfg = load_model_config(LM_CONF)
    assert cfg.precision == "bfloat16", cfg.precision
    return Trainer(cfg, LM_SHAPES, device=dev, graphs=graphs,
                   log_fn=trainer_log)


def lm_batches(n, seed):
    from singa_tpu_torch import synthetic_token_batches
    data = synthetic_token_batches(8, LM_SEQ, 4096, seed=seed)
    return [next(data) for _ in range(n)]


def routing_of(layer, params, x):
    """The expert set and the kept flags of each token that `layer`
    (kMoE) routes when its input is x, as `moe_ffn` routes them."""
    from singa_tpu_torch.ops import moe
    b, s, e = x.shape
    router = params[layer.router].to(x.dtype)
    cap = moe.capacity(b * s, layer.k, layer.n_exp, layer.capacity_factor)
    r = moe.route(x.reshape(b * s, e), router, layer.k, cap)
    kept = torch.empty_like(r.slot)
    kept[r.order] = (r.slot < layer.n_exp * cap).long()
    experts = torch.sort(r.expert, dim=1).values
    return experts.cpu(), kept.reshape(b * s, layer.k).cpu(), cap


def lm_compare(dev, arrays):
    """(a) lm.conf's forward and every gradient in bf16, card against
    CPU, from the same weights and batch: the share of tokens that kMoE
    routes alike on both, each layer's output (moe1's on the tokens
    routed alike), the loss, and every gradient of the loss over the
    tokens routed alike (plus the aux loss).  kMoE sits in the last
    block, so a token's expert output reaches only its own position's
    loss: leaving the tokens routed apart out of the loss takes their
    routing out of every gradient."""
    from singa_tpu_torch.ops import _kernels
    batch = lm_batches(1, seed=1)[0]
    res = {}
    _kernels.reset_launches()
    for d in (dev, "cpu"):
        tr = lm_trainer(d, False)
        net = tr.train_net
        params = {k: v.requires_grad_(True) for k, v in
                  start(tr, arrays, d)[0].items()}
        loss, metrics, out = net.apply(params, batch, train=True,
                                       compute_dtype=torch.bfloat16,
                                       rng=tr.seed, step=0)
        with torch.no_grad():
            route = routing_of(net.layers["moe1"], params, out["ln1b"])
        res[d] = dict(params=params, out=out, aux=metrics["moe1/aux"],
                      loss=loss.item(), route=route)
        log(f"[lmconf] (a) b=8 s={LM_SEQ} bf16 on {d}: loss "
            f"{res[d]['loss']:.7f}, moe1/aux {metrics['moe1/aux'].item():.7f}")
    card_, cpu = res[dev], res["cpu"]
    (e_c, k_c, cap), (e_p, k_p, _) = card_["route"], cpu["route"]
    same_set = (e_c == e_p).all(dim=1)
    alike = same_set & (k_c == k_p).all(dim=1)
    dropped = int((k_p == 0).sum())
    log(f"[lmconf] (a) moe1 routing, card against CPU: top-2 expert set "
        f"agrees on {float(same_set.float().mean()):.6f} of "
        f"{len(same_set)} tokens ({int((~same_set).sum())} differ); set "
        f"and capacity drops agree on {float(alike.float().mean()):.6f}; "
        f"capacity {cap} per expert, {dropped} of {k_p.numel()} "
        f"assignments dropped on the CPU")
    assert alike.float().mean() >= LM_ROUTED_ALIKE, alike.float().mean()
    for n in ("attn0", "attn1", "moe1"):
        got = card_["out"][n].detach().float().cpu()
        want = cpu["out"][n].detach().float()
        assert torch.isfinite(got).all(), n
        if n == "moe1":
            rows = alike.reshape(got.shape[:2])
            got, want = got[rows], want[rows]
        gap = (got - want).abs().max().item()
        top = want.abs().max().item()
        log(f"[lmconf] (a) {n}: max|card - cpu| {gap:.3g}, max|cpu| "
            f"{top:.3g}, ratio {gap / top:.3g} (tol {LM_OUT_RTOL})"
            + (" on the tokens routed alike" if n == "moe1" else ""))
        assert gap <= LM_OUT_RTOL * top, n
    lc, lp = card_["loss"], cpu["loss"]
    log(f"[lmconf] (a) loss gap |card - cpu| {abs(lc - lp):.3g} (rtol "
        f"{LM_LOSS_RTOL}); aux gap "
        f"{abs(card_['aux'].item() - cpu['aux'].item()):.3g}")
    assert abs(lc - lp) <= LM_LOSS_RTOL * abs(lp), (lc, lp)
    grads = {}
    for d, r in res.items():
        logits, labels = r["out"]["lm_head"], r["out"]["labels"]
        nll = torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]).float(),
            labels.reshape(-1).long(), reduction="none")
        mask = alike.to(nll.device).float()
        objective = torch.sum(nll * mask) / torch.sum(mask) + r["aux"]
        names = sorted(r["params"])
        g = torch.autograd.grad(objective, [r["params"][n] for n in names])
        grads[d] = {n: x.float().cpu() for n, x in zip(names, g)}
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    assert launches == LM_PER_STEP, launches
    worst = 0.0
    for name in sorted(grads["cpu"]):
        want, got = grads["cpu"][name], grads[dev][name]
        top = want.abs().max().item()
        gap = (got - want).abs().max().item()
        worst = max(worst, gap / top)
        log(f"[lmconf] (a)   grad {name}: max|card - cpu| {gap:.3g}, "
            f"max|cpu| {top:.3g}, ratio {gap / top:.3g} (tol "
            f"{LM_GRAD_RTOL})")
        assert torch.isfinite(got).all() and gap <= LM_GRAD_RTOL * top, name
    log(f"[lmconf] (a) gradients of the loss over the "
        f"{int(alike.sum())} tokens routed alike: worst ratio {worst:.3g}; "
        f"launches on the card {launches}")


def lm_train(dev, arrays):
    """(b) eager steps against CUDA-graph replays from one copied start,
    equal under torch.equal after LM_EXACT steps and at the end; rounds
    in turns; train_steps; the loss over all steps; a profiled replay by
    kernel name; the MoE's share of a step's device time."""
    from singa_tpu_torch.ops import _kernels
    b = 8
    batches = lm_batches(LM_BATCHES, seed=0)
    runs = {}
    for mode, graphs in (("eager", False), ("graph", None)):
        tr = lm_trainer(dev, graphs)
        assert tr.graphs is (graphs is None), (mode, tr.graphs)
        params, opt = start(tr, arrays, dev)
        runs[mode] = dict(tr=tr, state=(params, opt), ms=[], step=0,
                          losses=[], aux=[])

    def steps(mode, n, check=False):
        run = runs[mode]
        params, opt = run["state"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            k = run["step"]
            before = dict(_kernels.LAUNCHES)
            params, opt, m = run["tr"].train_step(
                params, opt, batches[k % LM_BATCHES], k)
            loss, aux = torch.stack([m["loss"], m["moe1/aux"]]).tolist()
            run["losses"].append(loss)              # one fetch a step
            run["aux"].append(aux)
            if check:
                per = {x: _kernels.LAUNCHES[x] - before[x] for x in before}
                assert per == LM_PER_STEP, (mode, k, per)
            run["step"] += 1
        run["state"] = (params, opt)
        return (time.perf_counter() - t0) * 1e3 / n

    # the main path: counts from 0 just before, read just after
    _kernels.reset_launches()
    steps("graph", LM_EXACT, check=True)
    launches = dict(_kernels.LAUNCHES)
    captured = [g.launches for g in runs["graph"]["tr"]._train_graph
                ._graphs.values()]
    assert captured == [{k: v for k, v in LM_PER_STEP.items() if v}], \
        captured
    steps("eager", LM_EXACT, check=True)
    gaps = lm_state_gaps(runs["eager"]["state"], runs["graph"]["state"])
    log(f"[lmconf] (b) {LM_EXACT} eager steps and {LM_EXACT} replays from "
        f"one copied start: params and Adam state equal under torch.equal: "
        f"{not gaps}; losses equal: "
        f"{runs['eager']['losses'] == runs['graph']['losses']}")
    for name, gap in sorted(gaps.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[lmconf] (b)   {name}: max|graph - eager| {gap:.3g}")
    assert not gaps, f"{len(gaps)} tensors differ"
    for r in range(LM_ROUNDS):
        for mode in (("eager", "graph") if r % 2 == 0
                     else ("graph", "eager")):
            runs[mode]["ms"].append(steps(mode, LM_ROUND_STEPS))
    for mode, run in runs.items():
        params, opt = run["state"]
        idx = [(run["step"] + i) % LM_BATCHES for i in range(LM_ROUND_STEPS)]
        stacked = {"data": {f: torch.from_numpy(np.stack(
            [batches[i]["data"][f] for i in idx])).to(dev)
            for f in ("input", "target")}}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, ms = run["tr"].train_steps(params, opt, stacked,
                                                run["step"], LM_ROUND_STEPS,
                                                stacked=True)
        run["losses"] += ms["loss"].tolist()    # the one sync
        run["aux"] += ms["moe1/aux"].tolist()
        run["scan_ms"] = (time.perf_counter() - t0) * 1e3 / LM_ROUND_STEPS
        run["step"] += LM_ROUND_STEPS
        run["state"] = (params, opt)
        prof = profile(f"lm.conf train_step ({mode})",
                       lambda m=mode: steps(m, 1), min(run["ms"]), top=12)
        run["busy"], run["idle"], run["prof"] = \
            prof["busy_ms"], prof["idle"], prof
        if mode == "graph":
            check_replay_profile(prof, LM_PROFILED)
    for mode, run in runs.items():
        log(f"[lmconf] (b) {mode}: step "
            + ", ".join(f"{t:.3f}" for t in run["ms"])
            + f" ms in rounds 1-{LM_ROUNDS} of {LM_ROUND_STEPS} (turns, "
            f"host clock, one fetch a step), "
            + ", ".join(f"{b * LM_SEQ / t * 1e3:.1f}" for t in run["ms"])
            + f" tokens/s; train_steps({LM_ROUND_STEPS}) with one sync "
            f"{run['scan_ms']:.3f} ms a step, "
            f"{b * LM_SEQ / run['scan_ms'] * 1e3:.1f} tokens/s; profiled "
            f"step busy {run['busy']} ms, idle share {run['idle']}")
    gaps = lm_state_gaps(runs["eager"]["state"], runs["graph"]["state"])
    g = runs["graph"]
    log(f"[lmconf] (b) after {g['step']} steps each: equal under "
        f"torch.equal: {not gaps}; losses equal: "
        f"{runs['eager']['losses'] == g['losses']}")
    assert runs["eager"]["step"] == g["step"] and not gaps, \
        sorted(gaps.items(), key=lambda kv: -kv[1])[:8]
    losses, aux = g["losses"], g["aux"]
    tail = sum(losses[-5:]) / 5
    log(f"[lmconf] (b) {len(losses)} steps on {LM_BATCHES} repeated "
        f"batches: loss first {losses[0]:.5f}, mean of last 5 {tail:.5f} "
        f"(must be < first - {LOSS_MARGIN}); moe1/aux first {aux[0]:.6f}, "
        f"last {aux[-1]:.6f}; losses "
        + " ".join(f"{x:.4f}" for x in losses))
    assert all(math.isfinite(x) for x in losses + aux)
    assert tail < losses[0] - LOSS_MARGIN, losses
    moe_share(dev, arrays, g)
    return launches


def moe_share(dev, arrays, run):
    """kMoE's forward and backward alone at lm.conf's shape (bf16 input
    (8, 512, 256), the run's params), profiled: its device time split
    into the expert products (cuBLAS) and the dispatch (routing, sort,
    scatter, gather, index_add and their backward), beside the replayed
    step's busy time."""
    from singa_tpu_torch.ops import moe
    tr = run["tr"]
    layer = tr.train_net.layers["moe1"]
    params = run["state"][0]
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((8, LM_SEQ, 256), generator=g, device=dev).to(
        torch.bfloat16).requires_grad_(True)
    p = {n: params[k].to(torch.bfloat16).detach().requires_grad_(True)
         for n, k in (("router", layer.router), ("w1", layer.w1),
                      ("b1", layer.b1), ("w2", layer.w2), ("b2", layer.b2))}
    dy = torch.randn((8, LM_SEQ, 256), generator=g, device=dev).to(
        torch.bfloat16)

    def fwd_bwd():
        out, aux = moe.moe_ffn(x, p, layer.k, layer.capacity_factor)
        torch.autograd.backward([out, aux], [dy, torch.ones_like(aux)])
    ms = time_ms(fwd_bwd, 10, 2)
    prof = profile("kMoE forward+backward alone", fwd_bwd, ms, top=12)
    if not prof["ms"]:
        log("[lmconf] (b) kMoE share: not measured (no device time)")
        return
    gemm = sum(t for n, t in prof["ms"].items()
               if re.search(r"gemm|cutlass|xmma|sm90", n))
    busy = prof["busy_ms"]
    step = run["busy"]
    log(f"[lmconf] (b) kMoE forward+backward alone: {ms:.3f} ms "
        f"(events), device busy {busy:.3f} ms: expert products "
        f"{gemm:.3f} ms, dispatch {busy - gemm:.3f} ms "
        f"({100 * (busy - gemm) / busy:.1f}%); against the replayed "
        f"step's {step} ms busy: kMoE "
        + (f"{100 * busy / step:.1f}%, its dispatch "
           f"{100 * (busy - gemm) / step:.1f}%" if step else "not measured"))


def lm_decode(dev, arrays):
    """(c) beam_search (4 beams) and greedy generate, 32 new tokens from
    two 64-token prompts, f32 weights, on the card and on the CPU."""
    from singa_tpu_torch import (beam_search, build_net, generate,
                                 load_model_config, params_from_numpy)
    from singa_tpu_torch.models.generate import forward_cached, init_cache
    from singa_tpu_torch.ops import _kernels
    net = build_net(load_model_config(LM_CONF), "kTest", LM_SHAPES)
    prompts = np.random.default_rng(13).integers(0, 4096, (2, 64))
    res = {}
    _kernels.reset_launches()
    for d in (dev, "cpu"):
        params = params_from_numpy(net, arrays, device=d)
        t0 = time.perf_counter()
        with torch.no_grad():
            toks, scores = beam_search(net, params, prompts, 32, num_beams=4)
            greedy = generate(net, params, prompts, 32)
        res[d] = dict(beam=toks.cpu(), scores=scores.cpu(),
                      greedy=greedy.cpu(), params=params)
        log(f"[lmconf] (c) beam_search (4 beams) and greedy, 2 prompts of "
            f"64, 32 new tokens, f32 on {d}: "
            f"{time.perf_counter() - t0:.2f} s; beam scores "
            + ", ".join(f"{v:.5f}" for v in scores.tolist()))
    assert not any(_kernels.LAUNCHES.values()), _kernels.LAUNCHES
    card_, cpu = res[dev], res["cpu"]
    for what in ("beam", "greedy"):
        got, want = card_[what], cpu[what]
        assert got.shape == (2, 32) and ((got >= 0) & (got < 4096)).all()
        for i in range(2):
            same = torch.equal(got[i], want[i])
            line = (f"[lmconf] (c) {what} prompt {i}: card and CPU tokens "
                    f"equal: {same}")
            if not same:
                k = int((got[i] != want[i]).nonzero()[0, 0])
                seq = torch.cat([torch.from_numpy(prompts[i]),
                                 want[i][:k]])[None]
                with torch.no_grad():
                    logits, _ = forward_cached(
                        net, cpu["params"], seq,
                        init_cache(net, 1, seq.shape[1], device="cpu"), 0)
                top2 = logits[0, -1].topk(2).values
                line += (f"; first divergence at token {k}, where the "
                         f"CPU's top-2 logit gap is "
                         f"{float(top2[0] - top2[1]):.3g}")
            log(line)
    if torch.equal(card_["beam"], cpu["beam"]):
        gap = (card_["scores"] - cpu["scores"]).abs().max().item()
        log(f"[lmconf] (c) beam scores max|card - cpu| {gap:.3g} (tol 1e-3)")
        assert gap <= 1e-3, gap
    assert torch.isfinite(card_["scores"]).all()


LM_CB = dict(cb="on", cb_slots=8, cb_block_len=16, cb_prompt_cap=256,
             max_new_tokens=64, queue_capacity=64, request_timeout_s=600.0)


def lm_serve(dev, arrays):
    """(d) lm.conf served with f32 weights: one engine bucket (8, 128) x
    32 new tokens as a CUDA graph against an eager engine, then a
    continuous-batching run of 24 requests (8 slots) replayed against
    eager: every request served, the same answers (a MoE's capacity is
    shared by the rows of a call, so answers are held against the same
    traffic eager, not against generate)."""
    from singa_tpu_torch import (InferenceEngine, ServeSpec, build_net,
                                 load_model_config, params_from_numpy)
    from singa_tpu_torch.ops import _kernels
    net = build_net(load_model_config(LM_CONF), "kTest", LM_SHAPES)
    params = params_from_numpy(net, arrays, device=dev)
    rng = np.random.default_rng(17)
    prompts = [list(rng.integers(0, 4096, n))
               for n in (128, 100, 77, 64, 50, 33, 17, 5)]
    spec = ServeSpec(buckets=((8, 128),), max_new_tokens=32)
    _kernels.reset_launches()
    engines = {}
    for name, graphs in (("graph", None), ("eager", False)):
        eng = InferenceEngine(net, spec, params, device=dev, log_fn=log,
                              graphs=graphs)
        n = eng.warmup(("generate",))
        assert n == (1 if graphs is None else 0), (name, n)
        engines[name] = eng
    out = {k: np.stack(e.answer("generate", prompts))
           for k, e in engines.items()}
    assert out["graph"].shape == (8, 32) and \
        ((out["graph"] >= 0) & (out["graph"] < 4096)).all()
    assert np.array_equal(out["graph"], out["eager"]), \
        "replayed bucket tokens != eager"
    ms = in_turns({k: (lambda e=e: e.answer("generate", prompts))
                   for k, e in engines.items()})
    for k in ("eager", "graph"):
        log(f"[lmconf] (d) bucket (8, 128) x 32 new tokens, {k}: "
            + ", ".join(f"{t:.3f}" for t in ms[k])
            + " ms in rounds 1-3 (turns), "
            + ", ".join(f"{8 * 32 / t * 1e3:.1f}" for t in ms[k])
            + " tokens/s (prefill included); replay equals eager")
    prof = profile("lm.conf bucket generate (graph)",
                   lambda: engines["graph"].answer("generate", prompts),
                   min(ms["graph"]))
    log(f"[lmconf] (d) bucket generate (graph): idle share {prof['idle']}")
    del engines
    crng = np.random.default_rng(19)
    cprompts = [crng.integers(0, 4096, n).astype(np.int32)
                for n in crng.integers(16, 257, 24)]
    cmax = [int(m) for m in crng.integers(8, 65, 24)]
    answers = {}
    for name, graphs in (("graph", None), ("eager", False)):
        eng, _, outs, wall = serve_cb(net, params, dev, cprompts, cmax,
                                      graphs, **LM_CB)
        answers[name] = [o["tokens"] for o in outs]
        ntok = sum(len(a) for a in answers[name])
        snap = eng.stats.snapshot()
        log(f"[lmconf] (d) cb {name}: {len(outs)} of 24 requests served "
            f"(finish length), 0 failed, {snap['cb_steps']} scheduler "
            f"steps, {ntok} tokens in {wall:.3f} s = {ntok / wall:.1f} "
            f"generated tokens/s; latency p50/p99 {snap['p50_latency_ms']}"
            f"/{snap['p99_latency_ms']} ms")
        del eng
    assert answers["graph"] == answers["eager"], "cb replay != eager"
    assert not any(_kernels.LAUNCHES.values()), _kernels.LAUNCHES
    log("[lmconf] (d) cb replayed answers equal eager ones, all 24")


def phase_lmconf(dev):
    """Phase 10: examples/transformer/lm.conf uncut (B=8, S=512, V=4096,
    E=256, 2 blocks, the second a kMoE of 4 experts top-2, bf16, Adam)
    with numpy-seeded weights."""
    from singa_tpu_torch import build_net, load_model_config, numpy_params
    arrays = numpy_params(build_net(load_model_config(LM_CONF), "kTrain",
                                    LM_SHAPES), seed=0)
    lm_compare(dev, arrays)
    launches = lm_train(dev, arrays)
    lm_decode(dev, arrays)
    lm_serve(dev, arrays)
    return launches



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from singa_tpu_torch import build_net, numpy_params, transformer_lm
    from singa_tpu_torch.ops import _kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    global CARD
    smi = card()
    log(f"[card] {smi}; torch {torch.__version__}, cuda "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    CARD = smi

    clock = [time.perf_counter()]

    def took(what):
        now = time.perf_counter()
        log(f"[time] {what}: {now - clock[0]:.1f} s")
        clock[0] = now

    t0 = time.perf_counter()
    logs = _kernels.build()
    log(f"[build] {sorted(logs)} built in {time.perf_counter() - t0:.1f} s")
    for name, text in sorted(logs.items()):
        for fn, usage in ptxas_usage(text):
            log(f"[build] {name}: {fn}: {usage}")
    for name in ("flash_fwd", "head_fwd", "flash_dq", "flash_dkv"):
        counts = sass_hmma(name)
        for fn, n in sorted(counts.items()):
            log(f"[build] {name}: {fn}: {n} HMMA instructions")
        mma = sum(n for fn, n in counts.items() if "_mma_kernel" in fn)
        log(f"[build] {name}: {mma} HMMA instructions in its bf16 "
            f"(tensor-core) body")
        assert mma > 0, (name, counts)
    took("phase 1")

    k1, k2 = phase_kernels(dev)
    took("phase 2")
    net = build(BENCH, BENCH["seq_len"])
    arrays = numpy_params(net, seed=0)
    launches = phase_forward(dev, arrays)
    # the forward went through the kernels: 12 attention layers, 1 head
    assert launches == {"flash_fwd": 12, "head_fwd": 1, "flash_dq": 0,
                        "flash_dkv": 0, "lrn_fwd": 0, "lrn_bwd": 0}, launches
    took("phase 3")
    phase_serve(dev, arrays)
    took("phase 4a")
    phase_cb(dev, arrays)
    took("phase 4b")
    k34 = phase_flash_bwd(dev)
    took("phase 5")
    phase_grads(dev, arrays)
    took("phase 6")
    launches = phase_train(dev, arrays)
    phase_graphs(dev, arrays)
    phase_resume(dev, arrays)
    took("phase 7")
    k56 = phase_lrn(dev)
    took("phase 8")
    launches.update({k: v for k, v in phase_alexnet(dev).items()
                     if k in ("lrn_fwd", "lrn_bwd")})
    took("phase 9")
    phase_lmconf(dev)
    took("phase 10")

    kernels = []
    for name, res, replaces in (
            ("flash_fwd", k1, "singa_tpu/ops/attention.py:335"),
            ("head_fwd", k2, "singa_tpu/ops/head_loss.py:35"),
            ("flash_dq", k34["dq"], "singa_tpu/ops/attention.py:418"),
            ("flash_dkv", k34["dkv"], "singa_tpu/ops/attention.py:479"),
            ("lrn_fwd", k56["lrn_fwd"], "singa_tpu/ops/lrn_pallas.py:62"),
            ("lrn_bwd", k56["lrn_bwd"], "singa_tpu/ops/lrn_pallas.py:70")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"singa_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": res["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
