"""serve.slot_occupancy: active decode slots over compiled slots,
averaged over the scheduler's steps inside the window, in %: the
difference of `ServeStats`' counters `cb_active_slot_steps` and
`cb_steps` across the window."""


def read(rec):
    s = rec.get("serve")
    if not s or s["slot_occupancy"] is None:
        return None
    return 100.0 * s["slot_occupancy"]
