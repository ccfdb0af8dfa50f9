"""serve.mfu: model FLOPs of the prefills started and the tokens decoded
inside the window (the frozen forward counts of `counts/flops.py`: a
prompt's forward, and per decoded token the products, attention over
its context and the head) over the window's host-clock seconds and the
card's bf16 peak, in %."""

from bench_port.metrics._common import counts


def read(rec):
    s = rec.get("serve")
    if not s:
        return None
    peaks = counts().peaks(rec.get("device_kind", ""))
    if peaks is None or s["window_s"] <= 0:
        return None
    return 100.0 * s["flops"] / (s["window_s"] * peaks[0])
