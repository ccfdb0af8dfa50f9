#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (singa_tpu_torch), one GPU.

    python3 chip_smoke.py

run from the root of a checkout, on a machine with one NVIDIA H100 and
the CUDA toolkit.  Phases, none of them caught — any failure exits
non-zero before the last line is printed:

1. Card and build: the card's name and power limit, then nvcc builds
   every kernel from singa_tpu_torch/csrc (one process per source, in
   parallel); build time and ptxas resource lines are printed.
2. Kernels against their plain PyTorch versions on the card, at the
   bench shapes and a few more (GQA, non-causal, every head dim, both
   dtypes, ragged edges), each with its stated tolerance; kernel, plain
   and library times by CUDA events.
3. The scoring forward, the slice's main path: the repo's bench stack
   (transformer_lm 12L, E=768, 12 heads of 64, V=32768, S=1024, B=8,
   bf16 compute) with random weights from a numpy seed, through
   `NeuralNet.apply(train=False)`.  The launch counts are set to 0 just
   before and read just after: K1 must run 12 times and K2 once.  Then
   the same weights at 2 layers and batch 2 on the card and on the CPU:
   each attention layer's output, K2's per-token lse, label logit and
   hit, and the loss must agree.
4. Serving: the bucketed engine answers greedy and sampled generate
   requests and predict requests on the same stack (f32 weights); greedy
   answers must equal `generate` on the unpadded prompts.

The line before the last is one JSON object listing each kernel with
its launches, error, times and bound; the line before that the card's
`nvidia-smi` name and power limit; the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
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


def log(msg: str) -> None:
    print(msg, flush=True)


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


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profile(tag: str, fn, wall_ms: float, top: int = 8) -> None:
    """One traced call of `fn`: device time by kernel name, and the
    device's busy and idle share of `wall_ms`, an untraced call's time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    busy = sum(by_name.values())
    if not by_name:
        log(f"[profile] {tag}: the profiler recorded no device time "
            f"(busy share not measured)")
        return
    log(f"[profile] {tag}: device busy {busy:.3f} ms of {wall_ms:.3f} ms "
        f"untraced wall, idle share {max(0.0, 1 - busy / wall_ms):.3f}, "
        f"{len(by_name)} kernel names")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"[profile] {tag}:   {t:9.3f} ms  {100 * t / busy:5.1f}%  "
            f"{name[:90]}")


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
    # both sides compute in f32 and differ only in summation order; a
    # bf16 output may then round one ulp apart (|O| < 4: ulp <= 2^-6)
    tol_o = 2e-2 if dtype == torch.bfloat16 else 1e-4
    tol_l = 1e-3
    tag = (f"K1 flash_fwd b={b} s={s} h={h} hkv={hkv} d={d} "
           f"{str(dtype).split('.')[-1]} causal={causal}")
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    assert err_o <= tol_o and err_l <= tol_l, (tag, err_o, err_l)
    res = {"max_abs_err": err_o}
    if timed:
        res["ms"] = time_ms(lambda: A.flash_attention_packed_lse(
            q, k, v, h, causal, hkv), 20)
        res["plain_ms"] = time_ms(lambda: A.flash_forward_plain(
            q, k, v, h, causal, hkv), 5, 1)
        qs = q.view(b, s, h, d).transpose(1, 2)
        ks = k.view(b, s, hkv, d).transpose(1, 2)
        vs = v.view(b, s, hkv, d).transpose(1, 2)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        res["library_ms"] = (time_ms(lambda: sdpa(qs, ks, vs,
                                                  is_causal=causal), 20)
                             if h == hkv else None)
        pairs = s * (s + 1) // 2 if causal else s * s
        esz = q.element_size()
        nbytes = (2 * b * s * h * d + 2 * b * s * hkv * d) * esz \
            + b * s * h * 4
        res["bound_ms"], res["bound_by"] = bound(
            nbytes, 4.0 * d * pairs * b * h, dtype)
    log(f"[kernels] {tag}: max|dO| {err_o:.3g} (tol {tol_o}), "
        f"max|dlse| {err_l:.3g} (tol {tol_l})"
        + (f", kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
           f"sdpa {res['library_ms']} ms, bound {res['bound_ms']:.4f} ms "
           f"({res['bound_by']})" if timed else ""))
    return res


def check_head(n, e, v, dtype, dev, seed, timed=False):
    from singa_tpu_torch.ops import head_loss as H
    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn((n, e), generator=g, device=dev).to(dtype)
    w = (torch.randn((v, e), generator=g, device=dev)
         / math.sqrt(e)).to(dtype)
    labels = torch.randint(0, v, (n,), generator=g, device=dev)
    lse, ll, hit = H.head_stats(h, w, labels)
    torch.cuda.synchronize()
    r_lse, r_ll, r_hit = H.head_stats_plain(h, w, labels)
    err = max((lse - r_lse).abs().max().item(),
              (ll - r_ll).abs().max().item())
    agree = (hit == r_hit).float().mean().item()
    # f32 sums of E products in another order: ~1e-6 relative; a hit
    # may flip only where the two best logits tie that closely
    tag = f"K2 head_fwd n={n} e={e} v={v} {str(dtype).split('.')[-1]}"
    assert torch.isfinite(lse).all() and torch.isfinite(ll).all()
    assert torch.allclose(lse, r_lse, rtol=1e-4, atol=1e-4), tag
    assert torch.allclose(ll, r_ll, rtol=1e-4, atol=1e-4), tag
    assert agree >= 0.999, (tag, agree)
    res = {"max_abs_err": err}
    if timed:
        res["ms"] = time_ms(lambda: H.head_stats(h, w, labels), 5, 1)
        res["plain_ms"] = time_ms(lambda: H.head_stats_plain(h, w, labels),
                                  3, 1)
        res["library_ms"] = None
        esz = h.element_size()
        res["bound_ms"], res["bound_by"] = bound(
            (n * e + v * e) * esz + n * 8 + 3 * n * 4, 2.0 * n * v * e,
            dtype)
    log(f"[kernels] {tag}: max err {err:.3g} (rtol/atol 1e-4), hit "
        f"agreement {agree:.5f} (>= 0.999)"
        + (f", kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
           f"bound {res['bound_ms']:.4f} ms ({res['bound_by']})"
           if timed else ""))
    return res


def phase_kernels(dev):
    bf16, f32 = torch.bfloat16, torch.float32
    k1 = check_flash(8, 1024, 12, 12, 64, bf16, True, dev, 1, timed=True)
    check_flash(8, 1024, 12, 4, 64, bf16, True, dev, 2)      # GQA
    check_flash(8, 1024, 12, 12, 64, bf16, False, dev, 3)    # non-causal
    check_flash(8, 1024, 12, 12, 32, bf16, True, dev, 4)     # D=32
    check_flash(2, 1024, 8, 8, 96, bf16, True, dev, 8)       # D=96, padded
    # every tile width, padded widths, and D past 128 in 128-wide chunks
    for i, d in enumerate((8, 16, 24, 32, 40, 64, 96, 128, 136, 264)):
        check_flash(2, 200, 4, 2, d, f32, True, dev, 10 + i)  # ragged S
        check_flash(1, 256, 2, 1, d, bf16, False, dev, 30 + i)
    k2 = check_head(8192, 768, 32768, bf16, dev, 5, timed=True)
    check_head(2048, 768, 32768, f32, dev, 6)
    check_head(100, 96, 1000, f32, dev, 7)                    # ragged
    return k1, k2


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
    profile("forward", forward, ms)

    # the same weights at 2 layers, batch 2 (N = 2048, still K2-legal):
    # card (kernels) against CPU (plain versions), both bf16 compute, on
    # what the kernels decide: each attention layer's output and K2's
    # per-token lse, label logit and hit on the final hidden state.
    compare_small(dev, arrays)
    return launches


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
# phase 4: serving


def phase_serve(dev, arrays):
    from singa_tpu_torch import (InferenceEngine, ServeSpec, generate,
                                 params_from_numpy)
    from singa_tpu_torch.models.generate import forward_cached, init_cache
    vocab = BENCH["vocab_size"]
    net = build(BENCH, BENCH["seq_len"])
    params = params_from_numpy(net, arrays, device=dev)
    rng = np.random.default_rng(7)
    prompts = [list(rng.integers(0, vocab, n))
               for n in (128, 100, 77, 64, 50, 33, 17, 5)]
    bucket, max_new = (8, 128), 32
    greedy = InferenceEngine(net, ServeSpec(buckets=(bucket,),
                                            max_new_tokens=max_new),
                             params, device=dev)
    out = np.stack(greedy.answer("generate", prompts))
    assert out.shape == (8, max_new) and (out >= 0).all() \
        and (out < vocab).all()
    t0 = time.perf_counter()        # a warm run: answers come back on host
    again = np.stack(greedy.answer("generate", prompts))
    dt = time.perf_counter() - t0
    assert np.array_equal(out, again), "greedy runs differ"
    profile("decode", lambda: greedy.answer("generate", prompts), dt * 1e3)
    for row, prompt in zip(out, prompts):
        with torch.no_grad():
            want = generate(net, params, np.array([prompt]), max_new)
        assert np.array_equal(row, want[0].cpu().numpy()), \
            ("padded greedy != unpadded generate", len(prompt))
    log(f"[serve] greedy bucket {bucket} x {max_new} new tokens (prefill "
        f"included): {dt:.3f} s, {8 * max_new / dt:.1f} tokens/s; equals "
        f"unpadded generate; two runs identical")

    # predict: next-token log-probs of the padded bucket against
    # forward_cached on each unpadded prompt (f32: rtol/atol 1e-3 covers
    # the reordered sums of shifted RoPE positions and batch shapes)
    lp = greedy.answer("predict", prompts)
    for row, prompt in zip(lp, prompts):
        with torch.no_grad():
            cache = init_cache(net, 1, len(prompt) + 1, torch.float32, dev)
            logits, _ = forward_cached(net, params, np.array([prompt]),
                                       cache, 0)
            want = torch.log_softmax(logits[0, -1], dim=-1).cpu().numpy()
        np.testing.assert_allclose(row, want, rtol=1e-3, atol=1e-3)
    log("[serve] predict bucket matches forward_cached per prompt")

    sampled = []
    for _ in range(2):
        eng = InferenceEngine(net, ServeSpec(buckets=(bucket,),
                                             max_new_tokens=max_new,
                                             temperature=0.8, top_k=50,
                                             top_p=0.9, seed=3),
                              params, device=dev)
        sampled.append(np.stack(eng.answer("generate", prompts)))
    s0 = sampled[0]
    assert s0.shape == (8, max_new) and (s0 >= 0).all() \
        and (s0 < vocab).all()
    assert np.array_equal(sampled[0], sampled[1]), "seeded sampling differs"
    log(f"[serve] top-k/top-p sampled bucket: {len(set(s0.ravel()))} "
        f"distinct tokens, reproducible from its seed")


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
    smi = card()
    log(f"[card] {smi}; torch {torch.__version__}, cuda "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = _kernels.build()
    log(f"[build] {sorted(logs)} built in {time.perf_counter() - t0:.1f} s")
    for name, text in sorted(logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    k1, k2 = phase_kernels(dev)

    net = build(BENCH, BENCH["seq_len"])
    arrays = numpy_params(net, seed=0)
    launches = phase_forward(dev, arrays)
    # the main path went through the kernels: 12 attention layers, 1 head
    assert launches == {"flash_fwd": 12, "head_fwd": 1}, launches
    phase_serve(dev, arrays)

    kernels = []
    for name, res, replaces, source in (
            ("flash_fwd", k1, "singa_tpu/ops/attention.py:335",
             "singa_tpu_torch/csrc/flash_fwd.cu"),
            ("head_fwd", k2, "singa_tpu/ops/head_loss.py:35",
             "singa_tpu_torch/csrc/head_fwd.cu")):
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": res["library_ms"]})
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
