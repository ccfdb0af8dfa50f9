"""Render a merged fleet trace (obs/collect.py output, or any single
process's Chrome-trace JSON) as a per-request text timeline with
critical-path attribution — the post-mortem read when no Perfetto UI
is at hand.

    python -m singa_tpu_torch.tools.trace_timeline trace.json [--trace ID] [--top N]

Without `--trace` every trace id in the file is listed (span count +
end-to-end span) and the LAST one is rendered.  The timeline section
shows the span tree in timestamp order with process/engine tags; the
attribution section ranks spans by SELF time (duration minus child
overlap, `collect.critical_path`) — the head of that list is where
the request's wall-clock actually went.  The port's own copy of
`tools/trace_timeline.py`; it reads either package's merged traces.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..obs import collect


def _fmt_us(us: float) -> str:
    if us >= 1e6:
        return f"{us / 1e6:.3f}s"
    if us >= 1e3:
        return f"{us / 1e3:.3f}ms"
    return f"{us:.0f}us"


def render(merged, trace_id: str, top: int = 10) -> str:
    spans = collect.spans_of(merged, trace_id)
    if not spans:
        return f"trace {trace_id}: no spans"
    processes = merged.get("processes", {})
    by_id = {e["args"]["span_id"]: e for e in spans}
    t0 = min(e["ts"] for e in spans)
    t1 = max(e["ts"] + e.get("dur", 0.0) for e in spans)

    def depth(e):
        d, seen = 0, set()
        while True:
            pid = e["args"].get("parent_id")
            parent = by_id.get(pid)
            if parent is None or pid in seen:
                return d
            seen.add(pid)
            d, e = d + 1, parent
    lines = [f"trace {trace_id}: {len(spans)} span(s), "
             f"{_fmt_us(t1 - t0)} end to end"]
    orphan_ids = {e["args"]["span_id"]
                  for e in collect.orphans(merged, trace_id)}
    if orphan_ids:
        lines.append(f"  WARNING: {len(orphan_ids)} orphan span(s) "
                     f"(parent not in file)")
    lines.append("")
    lines.append("timeline:")
    for e in spans:
        a = e["args"]
        tags = [processes.get(e.get("pid"), str(e.get("pid")))]
        if a.get("engine"):
            tags.append(str(a["engine"]))
        if a.get("corr"):
            tags.append(str(a["corr"]))
        flag = " ORPHAN" if a["span_id"] in orphan_ids else ""
        lines.append(
            f"  +{_fmt_us(e['ts'] - t0):>10} "
            f"{'  ' * depth(e)}{e['name']} "
            f"[{_fmt_us(e.get('dur', 0.0))}] "
            f"({', '.join(tags)}){flag}")
    lines.append("")
    lines.append(f"critical path (self time, top {top}):")
    total = max(t1 - t0, 1e-9)
    for row in collect.critical_path(merged, trace_id)[:top]:
        where = row["process"] + (f"/{row['engine']}"
                                  if row.get("engine") else "")
        lines.append(
            f"  {_fmt_us(row['self_us']):>10} "
            f"{100.0 * row['self_us'] / total:5.1f}%  "
            f"{row['name']} ({where})")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="text timeline + critical path for one trace id "
                    "in a merged fleet trace")
    ap.add_argument("path", help="merged trace JSON "
                                 "(obs/collect.py output)")
    ap.add_argument("--trace", default=None,
                    help="trace id to render (default: list all, "
                         "render the last)")
    ap.add_argument("--top", type=int, default=10,
                    help="critical-path rows to show")
    args = ap.parse_args(argv)
    with open(args.path) as f:
        merged = json.load(f)
    ids = collect.trace_ids(merged)
    if not ids:
        print("no spans with trace ids in this file")
        return 1
    if args.trace is None:
        print(f"{len(ids)} trace id(s) in {args.path}:")
        for t in ids:
            s = collect.spans_of(merged, t)
            t0 = min(e["ts"] for e in s)
            t1 = max(e["ts"] + e.get("dur", 0.0) for e in s)
            print(f"  {t}  {len(s):>4} span(s)  {_fmt_us(t1 - t0)}")
        print()
        args.trace = ids[-1]
    elif args.trace not in ids:
        print(f"trace {args.trace!r} not in this file "
              f"(have: {', '.join(ids)})")
        return 1
    print(render(merged, args.trace, top=args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
