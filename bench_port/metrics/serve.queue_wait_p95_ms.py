"""serve.queue_wait_p95_ms: 95th percentile over every request due in
the window of due instant to the start of its prefill, from the
benchmark's own stamps (a request never prefilled counts as missing)."""


def read(rec):
    s = rec.get("serve")
    if not s or s["queue_wait_p95_s"] == float("inf"):
        return None
    return s["queue_wait_p95_s"] * 1e3
