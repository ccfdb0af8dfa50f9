"""lm_train.attn_roofline: the share of their roofline that the flash
attention kernels K1, K3 and K4 reach in the traced span, in %: the sum
over their launches of max(operations / peak FLOP/s, bytes / peak
bytes/s), from the cell's shapes with the causal half
(`counts.flops.attention_kernel_work`), over their summed device time."""

from bench_port.metrics._common import counts, family, kernel_time


def read(rec):
    if family(rec) != "lm" or "steps" not in rec:
        return None
    c = counts()
    peaks = c.peaks(rec.get("device_kind", ""))
    if peaks is None:
        return None
    m = c.lm_dims(rec["config"])
    b, s = rec["cell"]["batch"], rec["cell"]["seq"]
    least = spent = 0.0
    for k in ("flash_fwd", "flash_dq", "flash_dkv"):
        sec, n = kernel_time(rec, k)
        if not n:
            continue
        ops, nbytes = c.attention_kernel_work(k, b, s, m["H"], m["Hkv"],
                                              m["D"])
        least += n * max(ops / peaks[0], nbytes / peaks[1])
        spent += sec
    return 100.0 * least / spent if spent > 0 else None
