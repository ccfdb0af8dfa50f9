"""vision_train.lrn_roofline: the share of their byte bound that the LRN
kernels K5 and K6 reach in the traced span, in %: each launch reads
its inputs and writes its output once (`counts.flops.lrn_kernel_bytes`)
at the cell's kLRN shapes, launched in the net's order, over their
summed device time."""

from bench_port.metrics._common import counts, family, kernel_time


def read(rec):
    if family(rec) != "vision":
        return None
    c = counts()
    peaks = c.peaks(rec.get("device_kind", ""))
    if peaks is None:
        return None
    cfg = rec["config"]
    batch = cfg["model"]["neuralnet"]["layer"][0]["data_param"]["batchsize"]
    shapes = c.lrn_shapes(cfg, batch)
    least = spent = 0.0
    for k in ("lrn_fwd", "lrn_bwd"):
        sec, n = kernel_time(rec, k)
        if not n:
            continue
        per_net = sum(c.lrn_kernel_bytes(k, sh) for sh in shapes)
        least += n / len(shapes) * per_net / peaks[1]
        spent += sec
    return 100.0 * least / spent if spent > 0 else None
