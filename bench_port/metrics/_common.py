"""Helpers the per-layer readers share (not a metric)."""

from __future__ import annotations

from typing import Dict, Optional


def counts():
    """The frozen arithmetic of `bench_port/counts/flops.py`."""
    from bench_port.counts import flops
    return flops


def family(rec: Dict) -> Optional[str]:
    cfg = rec.get("config") or {}
    return cfg.get("family")


def idle_share(rec: Dict) -> Optional[float]:
    t = rec.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def train_mfu(rec: Dict, fam: str) -> Optional[float]:
    if family(rec) != fam or "step_flops" not in rec:
        return None
    peaks = counts().peaks(rec.get("device_kind", ""))
    if peaks is None or rec["untraced_s"] <= 0:
        return None
    return (100.0 * rec["step_flops"] * rec["untraced_steps"]
            / (rec["untraced_s"] * peaks[0]))


def kernel_time(rec: Dict, prefix: str) -> tuple:
    """(seconds, launches) of the traced kernels whose name starts with
    `prefix`."""
    t = rec.get("trace") or {}
    s = n = 0
    for name, (sec, cnt) in t.get("kernels", {}).items():
        if name.startswith(prefix):
            s += sec
            n += cnt
    return s, n
