"""The serving driver: an open loop of chat requests into
`ContinuousScheduler` over the paged KV cache, for `--seconds`.

Set-up makes the configuration's weights on the card in the type they
are served in, builds the engine with the cell's `ServeSpec`, starts the
scheduler (which captures the cb prefill and decode programs), and
serves a few requests of the cell's traffic to warm everything the
window runs.  The window sends the cell's schedule (`traffic.schedule`)
at its fixed rate; each request is timed from its due instant.  After
the close the driver waits up to `drain_s` for every request due in the
window; one that never finishes is a failure of `correct`.

End-to-end: `ttft_p95_ms`, the 95th percentile over every request due
in the window of due instant to first streamed token (a failed request
counts as missing it); `serve_tokens_per_s`, the tokens streamed inside
the window over its length.  The record carries the per-request stamps
for the per-layer readers.

`correct`: once the window has closed and the engine is freed, a sample
of finished requests drawn from the seed (the longest among them, then
others until `check_tokens` served tokens) is run through the float32
reference, teacher-forced on prompt and served tokens; the widest gap
by which a served token's logit lies below the reference's best must
stay under the cell's limit.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from .. import traffic, weights
from ..counts import flops
from ..models import lm_model_config, lm_shapes
from ..reference import lm as ref_lm
from ..reference import precision


def build(cfg: Dict, cell: Dict, seed: int, device):
    """(engine, scheduler, mark) serving the seed's weights; `mark[0]`
    holds when the engine's latest cb prefill started (the scheduler
    prefills a request right before it streams the first token)."""
    from singa_tpu_torch import InferenceEngine, ServeSpec, build_net
    from singa_tpu_torch.serve import ContinuousScheduler
    seq = cell["net_seq"]
    net = build_net(lm_model_config(cfg, 1, seq), "kTest", lm_shapes(seq))
    dtype = getattr(torch, cfg["serve"]["weights"])
    params = weights.make(ref_lm.param_shapes(cfg), seed, device, dtype)
    spec = ServeSpec(**cell["spec"])
    eng = InferenceEngine(net, spec, params, device=device,
                          log_fn=lambda msg: None)
    sched = ContinuousScheduler(eng, log_fn=lambda msg: None)
    mark = [0.0]
    prefill = eng.run_cb_prefill

    def stamped(*a, **k):
        mark[0] = time.perf_counter()
        return prefill(*a, **k)
    eng.run_cb_prefill = stamped
    return eng, sched, mark


def _counters(stats) -> tuple:
    with stats._lock:
        return stats.cb_steps, stats.cb_active_slot_steps


def _serve(sched, reqs: List[traffic.Request], seconds: float,
           drain_s: float, trace=None, mark=None) -> Dict:
    """Send `reqs` open-loop, wait for them; stamps and counters.  With
    `trace`, profile `trace.seconds` from `trace.lead_s` after the open."""
    eng = sched.engine
    loop = traffic.OpenLoop(reqs, lambda p, m: sched.submit(p, max_new=m),
                            mark)
    c0 = _counters(eng.stats)
    t_open = time.perf_counter()
    loop.start(t_open)
    if trace is not None:
        # the profiler starts and stops while the engine is held, between
        # two scheduler iterations: never beside a replay on the loop
        # thread
        time.sleep(trace.lead_s)
        with eng.hold():
            trace.start()
        time.sleep(trace.seconds)
        with eng.hold():
            trace.stop()
    left = t_open + seconds - time.perf_counter()
    if left > 0:
        time.sleep(left)
    t_close = time.perf_counter()
    c1 = _counters(eng.stats)
    loop.join(max(0.0, t_close + drain_s - time.perf_counter()))
    for r in reqs:
        if r.ticket is not None:
            r.ticket._done.wait(max(0.0, t_close + drain_s
                                    - time.perf_counter()))
    return {"t_open": t_open, "t_close": t_close, "late": loop.late,
            "counters": (c0, c1)}


def _p(values, q) -> float:
    """Nearest-rank percentile; inf stands for a missed request."""
    v = sorted(values)
    if not v:
        return float("nan")
    return v[min(len(v) - 1, max(0, math.ceil(q / 100 * len(v)) - 1))]


def summarize(cfg: Dict, reqs: List[traffic.Request], run: Dict,
              capacity: int) -> Dict:
    t_open, t_close = run["t_open"], run["t_close"]
    seconds = t_close - t_open
    ttft, qwait, gaps = [], [], []
    streamed, fl = 0, 0.0
    n_failed = n_done = 0
    for r in reqs:
        toks = traffic.tokens(r)
        done = traffic.finished(r)
        n_done += done
        if not done:
            n_failed += 1
        if toks:
            ttft.append(toks[0][0] - r.due_at)
            qwait.append(toks[0][1] - r.due_at)
            if t_open <= toks[0][1] <= t_close:
                fl += flops.lm_prefill_flops(cfg, len(r.prompt))
        else:
            ttft.append(math.inf)
            qwait.append(math.inf)
        for (a, _, _), (b, _, _) in zip(toks, toks[1:]):
            gaps.append(b - a)
        for j, (t, _, _) in enumerate(toks):
            if t_open <= t <= t_close:
                streamed += 1
                if j:
                    fl += flops.lm_decode_flops(cfg, len(r.prompt) + j)
    (s0, a0), (s1, a1) = run["counters"]
    return {"window_s": seconds, "requests": len(reqs), "finished": n_done,
            "failed": n_failed, "streamed": streamed, "flops": fl,
            "ttft_p95_s": _p(ttft, 95), "ttft_p50_s": _p(ttft, 50),
            "queue_wait_p95_s": _p(qwait, 95),
            "tpot_p50_s": _p(gaps, 50) if gaps else None,
            "slot_occupancy": ((a1 - a0) / ((s1 - s0) * capacity)
                               if s1 > s0 else None),
            "late_max_s": max(run["late"], default=0.0),
            "late_p95_s": _p(run["late"], 95) if run["late"] else 0.0}


def sample(reqs: List[traffic.Request], seed: int, want: int) -> List:
    """Finished requests to judge: the longest served, then others drawn
    from the seed until `want` served tokens."""
    done = [r for r in reqs if traffic.finished(r) and traffic.tokens(r)]
    if not done:
        return []
    done.sort(key=lambda r: -len(traffic.tokens(r)))
    out, n = [done[0]], len(traffic.tokens(done[0]))
    rng = np.random.default_rng(int(seed) % (1 << 63) + 1)
    for i in rng.permutation(len(done) - 1) + 1:
        if n >= want:
            break
        out.append(done[i])
        n += len(traffic.tokens(done[i]))
    return out


@torch.no_grad()
def served_gap(cfg: Dict, w: Dict, prompt: np.ndarray, served: List[int],
               device, mode: str = "f32", chooser: str = None) -> float:
    """Widest gap by which a served token's reference logit lies below
    the reference's best, over the served positions.  With `chooser`
    set, the token judged at each position is the one that precision
    puts first instead (the control)."""
    seq = np.concatenate([prompt, np.asarray(served[:-1], np.int32)])
    x = torch.from_numpy(seq).to(device)[None]
    lg = ref_lm.logits(cfg, w, x, mode)[0, len(prompt) - 1:]
    if chooser is None:
        pick = torch.as_tensor(served, device=device).long()
    else:
        pick = ref_lm.logits(cfg, w, x, chooser)[0, len(prompt) - 1:].argmax(-1)
    got = lg.gather(1, pick[:, None])[:, 0]
    return float((lg.max(-1).values - got).max())


def _ref_weights(cfg: Dict, seed: int, device) -> Dict:
    served = weights.make(ref_lm.param_shapes(cfg), seed, device,
                          getattr(torch, cfg["serve"]["weights"]))
    return {k: v.float() for k, v in served.items()}


def run(ctx) -> Dict:
    args, cfg, cell = ctx.args, ctx.config, ctx.cell
    device = torch.device(getattr(ctx, "device", "cuda"))
    eng, sched, mark = build(cfg, cell, args.seed, device)
    ctx.mark("engine_and_weights")
    sched.start()
    ctx.mark("captures")
    tr = cell["load"]
    warm = traffic.schedule(tr, cell["warm_s"], args.seed + 1,
                            cfg["vocab_size"])
    _serve(sched, warm, cell["warm_s"], cell["drain_s"], mark=mark)
    if any(not traffic.finished(r) for r in warm):
        raise RuntimeError("a warm-up request did not finish")
    reqs = traffic.schedule(tr, args.seconds, args.seed, cfg["vocab_size"])
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    sync()
    setup_s = time.perf_counter() - ctx.t0
    ctx.mark("warm_requests")
    got = _serve(sched, reqs, args.seconds, cell["drain_s"], mark=mark)
    s = summarize(cfg, reqs, got, eng.spec.cb_slots)
    trace = ctx.trace
    if trace is not None:
        # the device trace comes from a span of its own after the window,
        # at the window's load, so the profiler's host cost leaves the
        # window's stamps alone
        trace.lead_s, trace.seconds = cell["trace_lead_s"], cell["trace_s"]
        span = trace.lead_s + trace.seconds
        more = traffic.schedule(tr, span, args.seed + 2, cfg["vocab_size"])
        _serve(sched, more, span, cell["drain_s"], trace, mark)
        trace.finish()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    sched.stop()
    judged = sample(reqs, args.seed, cell["check_tokens"])
    stamps = [(r.prompt, [t for _, _, t in traffic.tokens(r)])
              for r in judged]
    del eng, sched
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    precision.strict_f32()
    w = _ref_weights(cfg, args.seed, device)
    gap = max((served_gap(cfg, w, p, t, device) for p, t in stamps),
              default=math.inf)
    short = max(0, cell["check_tokens"] - sum(len(t) for _, t in stamps))
    checks = [("served_gap", gap, cell["limits"]["served_gap"]),
              ("unfinished", s["requests"] - s["finished"], 0),
              ("judged_tokens_short", short, 0)]
    correct = math.isfinite(gap) and all(v <= lim for _, v, lim in checks)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)
    rec = {"device_kind": kind, "cell": cell, "config": cfg, "serve": s,
           "trace": trace.summary if trace is not None else None}
    if trace is not None:
        from ..harness import power_limit
        rec["power_limit"] = power_limit()
    ttft = s["ttft_p95_s"]
    return {"correct": bool(correct), "attempted": s["requests"],
            "failed": s["failed"],
            "e2e": {"ttft_p95_ms": ttft * 1e3 if math.isfinite(ttft)
                    else None,
                    "serve_tokens_per_s": s["streamed"] / s["window_s"],
                    "setup_s": setup_s},
            "rec": rec, "device": {"memory_peak_bytes": int(peak)},
            "checks": checks, "numbers": {"served_gap": gap, **s}}


def control_readings(cfg: Dict, cell: Dict, seed: int, device,
                     mode: str) -> Dict:
    """The control's widest gap on prompts and continuations made from
    the seed, at the sampled shapes of the cell's traffic."""
    precision.strict_f32()
    reqs = traffic.schedule(cell["load"], cell["control_s"], seed,
                            cfg["vocab_size"])
    rng = np.random.default_rng(int(seed) % (1 << 63) + 2)
    reqs.sort(key=lambda r: -r.max_new)
    picked, n = [reqs[0]], reqs[0].max_new
    for i in rng.permutation(len(reqs) - 1) + 1:
        if n >= cell["check_tokens"]:
            break
        picked.append(reqs[i])
        n += reqs[i].max_new
    w = _ref_weights(cfg, seed, device)
    gaps = [served_gap(cfg, w, r.prompt,
                       rng.integers(0, cfg["vocab_size"], r.max_new).tolist(),
                       device, "f32", chooser=mode) for r in picked]
    return {"control_gap": max(gaps), "judged_tokens": n,
            "requests": len(picked)}
