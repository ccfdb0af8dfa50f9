"""serve.tpot_p50_ms: the median gap between consecutive streamed
tokens of a request, over every gap of every request due in the
window."""


def read(rec):
    s = rec.get("serve")
    if not s or s["tpot_p50_s"] is None:
        return None
    return s["tpot_p50_s"] * 1e3
