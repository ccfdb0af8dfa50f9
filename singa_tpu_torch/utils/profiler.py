"""Profiling: the reference's TimerInfo phase report (worker.h:91-114)
on the card, through `torch.profiler`.

Port of `singa_tpu/utils/profiler.py`.  The reference accumulated
tForward_/tBackward_/tSyncParam_ around each phase and printed "% of
step per phase".  A replayed CUDA graph is one launch whose kernels no
profiler can split into phases, so the split comes from a trace of one
EAGER step (`Trainer.profile_phases`), whose device time is attributed
by what launched it:

  * the forward runs inside the `phase("fwd")` range and the update
    inside `phase("update")`, which the trainer's step opens: each is
    an `obs.span`, so a profiler that collects records it and a replay
    (host bookkeeping that a capture does not keep) has none;
  * the backward's kernels launch from the autograd engine's thread, in
    no range of the caller's, so they are attributed by the op that
    launched them: an op under `autograd::engine::evaluate_function: …`
    is backward work;
  * the hand-written kernels (K1-K6) launch through ctypes and have no
    aten op of their own: the profiler links each to the innermost range
    or autograd node open on its thread, so they join that one's phase.

The JAX package attributes fused HLO ops through the compiled module's
metadata (`hlo_attribution`); a PyTorch trace links each kernel to the
op that launched it instead, so that function has no counterpart here.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import json
import os
import time
from typing import Dict, Iterable, Iterator, Optional, Tuple

import torch

#: the record_function ranges a train step opens, by phase
RANGES = {"fwd": "singa::fwd", "update": "singa::update"}
#: the autograd engine's range around each backward node
BACKWARD = "autograd::engine::evaluate_function"
#: Chrome trace categories of device work
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def phase(name: str):
    """The span of train-step phase `name` ("fwd" or "update"):
    `obs.span(RANGES[name])`, a `record_function` range of that name
    while a profiler collects."""
    from .. import obs
    return obs.span(RANGES[name])


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def hard_sync(tree=None) -> None:
    """Wait for the device work feeding `tree`: a synchronize of the
    card its first tensor lives on (of the current card when `tree`
    holds none; nothing for CPU tensors).  Timing code calls this, since
    PyTorch returns before the card finishes."""
    leaf = next((t for t in _leaves(tree) if isinstance(t, torch.Tensor)),
                None)
    if leaf is None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    elif leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Trace the block with `torch.profiler` (CPU ops, and the card's
    kernels where there is one), yield the profile, and export it as a
    Chrome trace (`<logdir>/<ns>.pt.trace.json`, Perfetto-loadable)."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(logdir, f"{time.time_ns()}.pt.trace.json"))


class StepTimer:
    """Wall-clock step timing with compile-step exclusion."""

    def __init__(self, skip_first: int = 1):
        self.skip = skip_first
        self.times = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        if self.skip > 0:
            self.skip -= 1
        else:
            self.times.append(dt)

    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    def steps_per_sec(self) -> float:
        m = self.mean()
        return 1.0 / m if m else 0.0


def _self_times(events) -> collections.Counter:
    """Name → self microseconds of complete events that nest by time on
    each (pid, tid), as a Chrome trace's CPU ops do."""
    per_op = collections.Counter()
    by_thread = collections.defaultdict(list)
    for e in events:
        by_thread[(e.get("pid"), e.get("tid"))].append(e)
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        stack = []      # [end, name, self]
        for e in evs + [None]:
            while stack and (e is None or e["ts"] >= stack[-1][0]):
                end, name, own = stack.pop()
                per_op[name] += own
            if e is None:
                break
            dur = e.get("dur", 0)
            if stack:
                stack[-1][2] -= dur
            stack.append([e["ts"] + dur, e.get("name", "?"), dur])
    return per_op


def parse_trace_ops(outdir: str):
    """Per-op time from the newest Chrome trace under `outdir` (as
    `trace` exports it): (Counter op name → microseconds, total).  On
    the card the ops are its kernels, copies and fills; a trace with
    none (the CPU) counts the CPU ops' self time, as the JAX version
    counts the CPU backend's."""
    paths = glob.glob(os.path.join(outdir, "*.json"))
    if not paths:
        raise FileNotFoundError(f"no profiler trace under {outdir}")
    with open(max(paths, key=os.path.getmtime)) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in _DEVICE_CATS]
    if device:
        per_op = collections.Counter()
        for e in device:
            per_op[e.get("name", "?")] += e.get("dur", 0)
    else:
        per_op = _self_times([e for e in events
                              if e.get("cat") == "cpu_op"])
    return per_op, sum(per_op.values())


def classify_phase(names: Iterable[str]) -> Optional[str]:
    """fwd / bwd / update from the names of an op and its ancestors,
    nearest first: under an autograd backward node it is backward work,
    under `phase(...)`'s ranges forward or update; None outside all of
    them (the gradients' zero fill, a health probe)."""
    for name in names:
        if name.startswith(BACKWARD):
            return "bwd"
        if name == RANGES["update"]:
            return "update"
        if name == RANGES["fwd"]:
            return "fwd"
    return None


def _chain(event) -> Iterator[str]:
    while event is not None:
        yield event.name
        event = event.cpu_parent


def attribute(events) -> Tuple[Dict[Tuple[Optional[str], str], float],
                               float]:
    """({(phase or None, name): microseconds}, total microseconds) over
    a profile's `events()`.  With device events, each kernel (copy,
    fill) counts under the phase of the op that launched it (PyTorch
    lists it in that op's `kernels`) and the total is all device time;
    without (the CPU), each op's self CPU time counts."""
    from torch.autograd import DeviceType
    rows: Dict[Tuple[Optional[str], str], float] = collections.Counter()
    # a record_function range also leaves an event on the card's timeline
    # spanning its kernels and the gaps between them: not device work
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    if device:
        total = float(sum(e.time_range.elapsed_us() for e in device))
        seen = set()    # events that share a correlation id share kernels
        for e in events:
            if e.device_type != DeviceType.CPU or not e.kernels \
                    or e.id in seen:
                continue
            seen.add(e.id)
            ph = classify_phase(_chain(e))
            for k in e.kernels:
                rows[(ph, k.name)] += k.duration
    else:
        total = 0.0
        for e in events:
            total += e.self_cpu_time_total
            rows[(classify_phase(_chain(e)), e.name)] += \
                e.self_cpu_time_total
    return dict(rows), total


def phase_shares(events) -> Dict[str, float]:
    """{"fwd": f, "bwd": b, "update": u, "coverage": c}: phase fractions
    of the ATTRIBUTED time of a profile's `events()`, and the attributed
    share of all of it.  Coverage qualifies the shares: work outside
    every phase (the gradients' zero fill, health probes) is left out
    of them, as a fusion spanning phases is in the JAX package's."""
    rows, total = attribute(events)
    shares = {"fwd": 0.0, "bwd": 0.0, "update": 0.0}
    for (ph, _), us in rows.items():
        if ph is not None:
            shares[ph] += us
    attributed = sum(shares.values())
    denom = attributed or total or 1.0
    out = {k: v / denom for k, v in shares.items()}
    out["coverage"] = attributed / (total or 1.0)
    return out
