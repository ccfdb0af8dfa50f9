"""lm_train.mfu: the LM train step's model FLOPs (the frozen count of
`counts/flops.py`, 3x the forward) times the steps of the untraced
window over the window's host-clock seconds and the card's bf16 peak,
in %."""

from bench_port.metrics._common import train_mfu


def read(rec):
    return train_mfu(rec, "lm")
