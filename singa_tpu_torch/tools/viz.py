"""Net-structure and training-curve visualization — the role of the
reference's script/graph.py (net JSON → graph image) and script/draw.py
(performance-log → curves).  The port's own copy of
`singa_tpu/tools/viz.py`.

The net builder already emits the reference's node-link JSON
(graph.cc:4-59 format, NeuralNet.to_json / Graph.to_json); this module
turns that into Graphviz dot text (renderable anywhere) and plots metric
curves from either Trainer history dicts or training log text.

Usage:
  python -m singa_tpu_torch.tools.viz dot  <net.json> [out.dot]
  python -m singa_tpu_torch.tools.viz plot <train.log> [out.png]
"""

from __future__ import annotations

import json
import re
import sys
from typing import Dict, List, Optional


def json_to_dot(net_json: str, name: str = "net") -> str:
    """Node-link JSON → Graphviz dot.  Data layers get box shapes, loss
    layers doubleoctagons, everything else ellipses."""
    doc = json.loads(net_json)
    nodes = doc.get("nodes", [])
    links = doc.get("links", [])
    lines = [f'digraph "{name}" {{', "  rankdir=TB;"]
    for nd in nodes:
        nid = nd["id"]
        typ = nd.get("type", "")
        shape = ("box" if "Data" in typ or "Image" in typ or typ == "kLabel"
                 else "doubleoctagon" if "Loss" in typ else "ellipse")
        label = nid if not typ else f"{nid}\\n{typ}"
        lines.append(f'  "{nid}" [shape={shape}, label="{label}"];')
    for ln in links:
        s = nodes[ln["source"]]["id"]
        d = nodes[ln["target"]]["id"]
        lines.append(f'  "{s}" -> "{d}";')
    lines.append("}")
    return "\n".join(lines) + "\n"


# "step-120: loss : 0.523411, precision : 0.843750" (Performance.to_string)
_LOG_RE = re.compile(r"step-(\d+)(?: (validation|test))?: (.*)")


def parse_training_log(text: str) -> Dict[str, Dict[str, List]]:
    """Parse Trainer log lines into {series: {"step": [...], metric:
    [...]}} with series ∈ {train, test, validation}."""
    out: Dict[str, Dict[str, List]] = {}
    for line in text.splitlines():
        m = _LOG_RE.match(line.strip())
        if not m:
            continue
        step, phase, rest = int(m.group(1)), m.group(2) or "train", m.group(3)
        series = out.setdefault(phase, {"step": []})
        series["step"].append(step)
        for part in rest.split(","):
            if ":" not in part:
                continue
            k, v = part.split(":", 1)
            try:
                series.setdefault(k.strip(), []).append(float(v))
            except ValueError:
                pass
    return out


def plot_training_log(text: str, out_path: str) -> List[str]:
    """Render loss/metric curves from a training log (draw.py role).
    Returns the metric names plotted."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    series = parse_training_log(text)
    metrics = sorted({k for s in series.values() for k in s if k != "step"})
    if not metrics:
        raise ValueError("no Performance lines found in log")
    fig, axes = plt.subplots(1, len(metrics),
                             figsize=(5 * len(metrics), 3.6))
    if len(metrics) == 1:
        axes = [axes]
    for ax, metric in zip(axes, metrics):
        for phase, s in sorted(series.items()):
            if metric in s:
                n = min(len(s["step"]), len(s[metric]))
                ax.plot(s["step"][:n], s[metric][:n], label=phase)
        ax.set_xlabel("step")
        ax.set_ylabel(metric)
        ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return metrics


def main(argv: Optional[List[str]] = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) >= 2 and argv[0] == "dot":
        with open(argv[1]) as f:
            dot = json_to_dot(f.read())
        if len(argv) > 2:
            with open(argv[2], "w") as f:
                f.write(dot)
            print(f"wrote {argv[2]}")
        else:
            print(dot)
    elif len(argv) >= 2 and argv[0] == "plot":
        out = argv[2] if len(argv) > 2 else "training.png"
        with open(argv[1]) as f:
            metrics = plot_training_log(f.read(), out)
        print(f"plotted {metrics} to {out}")
    else:
        print(__doc__)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
