"""The port's benchmark: one cell, one run, one result line.

`main` reads `BENCHMARK.json` for the cell (its configuration, traffic
and metrics), reads the cell's own file `bench_port/cells/<cell>.json`
and the configuration's file, hands them to the driver the cell file
names (`bench_port/drivers/<driver>.py`), and prints what the driver
measured as one JSON line, the last of its standard output:

- with `--trace 0` the cell's end-to-end metrics;
- with `--trace 1` its per-layer metrics, each read by its own reader
  `bench_port/metrics/<metric>.py` (`read(rec)` returns a number, or
  None where it finds nothing to read), from the record the driver
  filled and from the device trace of a steady part of the window.

Every cell, configuration and per-layer metric is found by its name:
adding one is adding files and an entry in `BENCHMARK.json`.

A run refuses (exit code not 0, no result line) without a CUDA card, or
with fewer cards than the cell asks for, and when a module of JAX or of
the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import heapq
import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names the benchmark's process may not hold: JAX and
# the JAX package (the port's name begins with the latter's, so names
# are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "singa_tpu")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "python_function",
             "user_annotation")
WINDOW_MARK = "bench::window"


class Refused(RuntimeError):
    """The run cannot give a result here (no card, too few cards)."""


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def read_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def forbidden_modules(names=None) -> List[str]:
    """The forbidden top-level names among `names` (default: every
    module loaded), each module's name compared up to its first dot."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def benchmark(root: str = ROOT) -> Dict:
    return read_json(os.path.join(root, "BENCHMARK.json"))


def cell_files(bench: Dict, workload: str, root: str = ROOT) -> tuple:
    """(workload entry, cell file, configuration file) of `workload`."""
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cell = read_json(os.path.join(root, bench["paths"][0], "cells",
                                  f"{workload}.json"))
    if (cell["config"], cell["traffic"]) != (entry["config"],
                                             entry["traffic"]):
        raise SystemExit(f"cell file {workload}.json names "
                         f"{cell['config']}/{cell['traffic']}, "
                         f"BENCHMARK.json {entry['config']}/"
                         f"{entry['traffic']}")
    return entry, cell, read_json(os.path.join(root, conf["file"]))


def cell_metrics(bench: Dict, workload: str, kind: str) -> List[Dict]:
    """The `end_to_end` or `per_layer` metrics a cell reports: those that
    list it, and those without a list that move (or are) an end-to-end
    metric the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def reader(name: str):
    """`read` of `bench_port/metrics/<name>.py`."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"bench_port.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(name: str):
    return importlib.import_module(f"bench_port.drivers.{name}")


# -- the device trace --------------------------------------------------------

def short_name(name: str) -> str:
    """A kernel's name without `void `, anonymous namespaces, its
    template arguments and its parameter list."""
    n = name[5:] if name.startswith("void ") else name
    for anon in ("(anonymous namespace)::", "<unnamed>::"):
        n = n.replace(anon, "")
    for cut in ("(", "<"):
        i = n.find(cut)
        if i > 0:
            n = n[:i]
    return n.strip()[:96]


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events: List[Dict]) -> Dict:
    """Device time by kernel, the union of device activity, and the idle
    gaps by the host op running across each, inside the window mark of
    a Chrome trace's complete events."""
    mark = [e for e in events if e.get("name") == WINDOW_MARK
            and e.get("cat") == "user_annotation"]
    if not mark:
        raise RuntimeError("the trace holds no window mark")
    w0 = mark[0]["ts"]
    w1 = w0 + mark[0]["dur"]
    kernels: Dict[str, List[float]] = {}
    spans = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a, b = e["ts"], e["ts"] + e.get("dur", 0)
        if b <= w0 or a >= w1:
            continue
        a, b = max(a, w0), min(b, w1)
        spans.append((a, b))
        k = kernels.setdefault(short_name(e["name"]), [0.0, 0])
        k[0] += (b - a) * 1e-6
        k[1] += 1
    busy = _merge(spans)
    host = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"])
                  for e in events
                  if e.get("ph") == "X" and e.get("cat") in HOST_CATS
                  and e.get("name") != WINDOW_MARK)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps: Dict[str, float] = {}
    active: List[tuple] = []            # heap of (end, duration, name)
    i = 0
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2               # gaps come in time order
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(active, (host[i][1], host[i][1] - host[i][0],
                                    host[i][2]))
            i += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        label = (min(active, key=lambda x: x[1])[2] if active
                 else "host: no traced op")
        gaps[label] = gaps.get(label, 0.0) + (b - a) * 1e-6
    ops = sorted(([n, v[0]] for n, v in kernels.items()),
                 key=lambda x: -x[1])[:10]
    return {"window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "kernels": kernels,
            "device_ops": ops,
            "idle_gaps": sorted(([n, s] for n, s in gaps.items()),
                                key=lambda x: -x[1])[:10]}


class Trace:
    """torch.profiler over a steady span of a run, marked by a
    `bench::window` range.  `stop` ends the profile; `finish`, called
    once the measured window has closed, writes its Chrome export to a
    fixed file in the checkout's `build/` and summarises it."""

    def __init__(self, path: str):
        self.path = path
        self.summary: Optional[Dict] = None
        self._prof = self._mark = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._mark = record_function(WINDOW_MARK)
        self._mark.__enter__()

    def stop(self) -> None:
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)

    def finish(self) -> Dict:
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self._prof.export_chrome_trace(self.path)
        self._prof = None
        self.summary = summarize(read_json(self.path)["traceEvents"])
        return self.summary


# -- the run -----------------------------------------------------------------

class Context:
    """What a driver is handed: the arguments, the cell and
    configuration files, the process's start, the trace, and `mark`,
    which notes when each phase of set-up ended."""

    def __init__(self, args, cell: Dict, config: Dict, t0: float):
        self.args, self.cell, self.config = args, cell, config
        self.t0 = t0
        # set-up phases: name -> seconds since the process started
        self.marks: Dict[str, float] = {}
        self.trace = (Trace(os.path.join(ROOT, "build", "bench_trace",
                                         f"{args.workload}.json"))
                      if args.trace else None)


    def mark(self, name: str) -> None:
        self.marks[name] = time.perf_counter() - self.t0


def card(chips: int) -> Dict:
    """The card's name and count; refuses without enough CUDA cards."""
    import torch
    if not torch.cuda.is_available():
        raise Refused("torch.cuda.is_available() is false: this benchmark "
                      "measures the port on a CUDA card")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell asks for {chips} cards, "
                      f"{torch.cuda.device_count()} found")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}


def power_limit() -> Optional[str]:
    """nvidia-smi's power limit of card 0, or None."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(bench: Dict, workload: str, out: Dict, trace: bool) -> Dict:
    """The result object from a driver's output: the cell's end-to-end
    metrics (trace 0) or its per-layer metrics (trace 1), the checks
    last."""
    metrics = {}
    kind = "per_layer" if trace else "end_to_end"
    for m in cell_metrics(bench, workload, kind):
        value = (reader(m["name"])(out["rec"]) if trace
                 else out["e2e"].get(m["name"]))
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": bool(out["correct"]), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics,
            "device": out["device"]}
    if trace and out["rec"].get("trace"):
        t = out["rec"]["trace"]
        line["breakdown"] = {"device_ops": t["device_ops"],
                             "idle_gaps": t["idle_gaps"]}
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in out["checks"]}
    return line


def run_cell(bench: Dict, args, entry: Dict, cell: Dict, config: Dict,
             t0: float, dev: Dict, device: str = "cuda") -> tuple:
    """Everything of a run after the look for a card: (exit code, result
    line or None).  `device` "cpu" drives a run here (tests)."""
    ctx = Context(args, cell, config, t0)
    ctx.device = device
    import torch
    if device == "cuda":
        torch.cuda.init()
    ctx.mark("torch_and_context")
    out = driver(cell["driver"]).run(ctx)
    out["device"] = {**dev, **out["device"]}
    if args.trace:
        t = out["rec"]["trace"]
        out["device"]["busy_s"] = t["busy_s"]
        out["device"]["window_s"] = t["window_s"]
    found = forbidden_modules()
    if found:
        log(f"refused: the process holds {', '.join(found)} (JAX or the "
            f"JAX package), which the port must not load")
        return 4, None
    line = result_line(bench, args.workload, out, bool(args.trace))
    log("set-up ended at (s since start): " + ", ".join(
        f"{k} {v:.3f}" for k, v in ctx.marks.items()))
    print(f"correct: {line['correct']}", file=sys.stderr)
    for name, v, lim in out["checks"]:
        print(f"check {name}: {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0, line


# a run that has not ended by then prints every thread's stack and exits
# with an error instead of hanging the card
WATCHDOG_S = 350


def main(argv, t0: float) -> int:
    import faulthandler
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    args = parse(argv)
    bench = benchmark()
    entry, cell, config = cell_files(bench, args.workload)
    try:
        dev = card(entry["chips"])
    except Refused as e:
        log(f"refused: {e}")
        return 3
    rc, line = run_cell(bench, args, entry, cell, config, t0, dev)
    if line is not None:
        print(json.dumps(line), flush=True)
    return rc
