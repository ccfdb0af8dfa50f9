"""Fleet trace collector: pull per-process span buffers (`GET
/trace` or in-process `trace_dict()`s) and merge them into ONE
Perfetto-loadable file keyed by trace id.

Each process's tracer timestamps spans in microseconds relative to
its own `perf_counter` origin — meaningless across processes.  Every
buffer therefore carries `wall_origin_s`, the wall-clock instant of
its ts=0; the merge re-anchors every event onto the EARLIEST origin
among the buffers, so a router-side dispatch span and the worker-side
prefill span it caused line up on one timeline (to NTP skew, which is
noise at request granularity).  Span ids are minted from per-process
random bases (trace.py), so parent links resolve unambiguously after
the merge and re-pulling an overlapping buffer window dedupes cleanly
on `(pid, span_id)`.

`critical_path(...)` is the post-mortem read: for one trace id, walk
the span tree from its root and attribute the end-to-end latency to
the stages (and engines) that actually spent it — self time, not
inclusive time, so a parent that merely waited on its child reads as
cheap.  `tools/trace_timeline.py` prints this as text.

The port's own copy of `singa_tpu/obs/collect.py` (stdlib only there
too); it merges either package's `/trace` buffers.
"""

from __future__ import annotations

import json
import os
import urllib.request
from typing import Any, Dict, Iterable, List, Optional

__all__ = [
    "fetch_trace", "merge", "collect", "trace_ids", "spans_of",
    "orphans", "critical_path",
]


def fetch_trace(base_url: str, timeout: float = 5.0) -> Dict[str, Any]:
    """Pull one worker's span ring: `GET <base_url>/trace`."""
    url = base_url.rstrip("/") + "/trace"
    if not url.startswith("http"):
        url = "http://" + url
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8"))


def _is_span(ev: Dict[str, Any]) -> bool:
    return ev.get("ph") == "X"


def merge(buffers: Iterable[Dict[str, Any]],
          trace_id: Optional[str] = None) -> Dict[str, Any]:
    """Merge trace dicts from many processes into one, re-anchored
    onto the earliest wall origin, deduped on `(pid, span_id)` (span
    events) / `(pid, tid, name)` (metadata).  `trace_id` keeps only
    that request's spans — metadata rides along either way."""
    buffers = [b for b in buffers if b]
    origins = [b["wall_origin_s"] for b in buffers
               if b.get("wall_origin_s") is not None]
    base = min(origins) if origins else 0.0
    out: List[Dict[str, Any]] = []
    seen_spans = set()
    seen_meta = set()
    processes: Dict[int, str] = {}
    for buf in buffers:
        shift_us = ((buf["wall_origin_s"] - base) * 1e6
                    if buf.get("wall_origin_s") is not None else 0.0)
        pid = buf.get("pid")
        if pid is not None and buf.get("process"):
            processes[int(pid)] = str(buf["process"])
        for ev in buf.get("traceEvents", ()):
            if _is_span(ev):
                args = ev.get("args", {})
                if trace_id is not None and \
                        args.get("trace") != trace_id:
                    continue
                key = (ev.get("pid"), args.get("span_id"))
                if key[1] is not None and key in seen_spans:
                    continue
                seen_spans.add(key)
                ev = dict(ev)
                ev["ts"] = round(float(ev.get("ts", 0.0))
                                 + shift_us, 3)
                out.append(ev)
            elif ev.get("ph") == "M":
                key = (ev.get("pid"), ev.get("tid"), ev.get("name"),
                       str(ev.get("args")))
                if key in seen_meta:
                    continue
                seen_meta.add(key)
                out.append(ev)
    # metadata first (Perfetto applies names to subsequent events),
    # spans in timestamp order — the merged file reads chronologically
    meta = [e for e in out if e.get("ph") == "M"]
    spans = sorted((e for e in out if _is_span(e)),
                   key=lambda e: (e.get("ts", 0.0),
                                  e.get("dur", 0.0)))
    return {"traceEvents": meta + spans, "displayTimeUnit": "ms",
            "wall_origin_s": base, "processes": processes}


def collect(urls: Iterable[str], out: Optional[str] = None,
            trace_id: Optional[str] = None, timeout: float = 5.0,
            extra_buffers: Iterable[Dict[str, Any]] = ()
            ) -> Dict[str, Any]:
    """Pull every worker's `/trace` ring (plus any in-process
    buffers, e.g. the router's own `obs.trace_dump()`), merge, and
    optionally write the merged file.  Unreachable workers are
    skipped with a note in the result — a dead engine is often
    exactly why you are collecting."""
    buffers: List[Dict[str, Any]] = list(extra_buffers)
    unreachable: List[str] = []
    for u in urls:
        try:
            buffers.append(fetch_trace(u, timeout=timeout))
        except Exception:  # noqa: BLE001 — collect what is alive
            unreachable.append(str(u))
    merged = merge(buffers, trace_id=trace_id)
    if unreachable:
        merged["unreachable"] = unreachable
    if out:
        d = os.path.dirname(os.path.abspath(out))
        os.makedirs(d, exist_ok=True)
        tmp = out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(merged, f)
        os.replace(tmp, out)
    return merged


def trace_ids(merged: Dict[str, Any]) -> List[str]:
    """Distinct trace ids in first-appearance (timestamp) order."""
    seen: Dict[str, None] = {}
    for ev in merged.get("traceEvents", ()):
        if _is_span(ev):
            t = ev.get("args", {}).get("trace")
            if t is not None and t not in seen:
                seen[t] = None
    return list(seen)


def spans_of(merged: Dict[str, Any],
             trace_id: str) -> List[Dict[str, Any]]:
    """One request's spans, timestamp-ordered."""
    return sorted(
        (ev for ev in merged.get("traceEvents", ())
         if _is_span(ev)
         and ev.get("args", {}).get("trace") == trace_id),
        key=lambda e: (e.get("ts", 0.0), e.get("dur", 0.0)))


def orphans(merged: Dict[str, Any],
            trace_id: Optional[str] = None) -> List[Dict[str, Any]]:
    """Spans whose `parent_id` does not resolve within the merged
    file (optionally restricted to one trace) — a merged fleet trace
    with zero orphans is the proof that every hop re-anchored."""
    evs = (spans_of(merged, trace_id) if trace_id is not None
           else [e for e in merged.get("traceEvents", ())
                 if _is_span(e)])
    ids = {e["args"].get("span_id") for e in evs}
    return [e for e in evs
            if e["args"].get("parent_id")
            and e["args"]["parent_id"] not in ids]


def critical_path(merged: Dict[str, Any],
                  trace_id: str) -> List[Dict[str, Any]]:
    """Attribute one request's latency: every span of the trace with
    its SELF time (duration minus children's overlap with it),
    engine, and process, sorted by self time descending.  The head of
    the list is where the request's wall-clock actually went."""
    evs = spans_of(merged, trace_id)
    if not evs:
        return []
    processes = merged.get("processes", {})
    by_id = {e["args"]["span_id"]: e for e in evs}
    child_time: Dict[Any, float] = {}
    for e in evs:
        pid_ = e["args"].get("parent_id")
        parent = by_id.get(pid_)
        if parent is None:
            continue
        # clip the child's interval to the parent's: a child that
        # outlives its parent (async hand-off) only discounts overlap
        p0, p1 = parent["ts"], parent["ts"] + parent.get("dur", 0.0)
        c0, c1 = e["ts"], e["ts"] + e.get("dur", 0.0)
        overlap = max(0.0, min(p1, c1) - max(p0, c0))
        child_time[pid_] = child_time.get(pid_, 0.0) + overlap
    out = []
    for e in evs:
        args = e["args"]
        dur = float(e.get("dur", 0.0))
        self_us = max(0.0, dur - child_time.get(args["span_id"], 0.0))
        out.append({
            "name": e.get("name"), "ts": e.get("ts"), "dur_us": dur,
            "self_us": round(self_us, 3),
            "engine": args.get("engine"),
            "corr": args.get("corr"),
            "process": processes.get(e.get("pid"),
                                     str(e.get("pid"))),
            "span_id": args["span_id"],
            "parent_id": args.get("parent_id", 0),
        })
    out.sort(key=lambda r: -r["self_us"])
    return out
