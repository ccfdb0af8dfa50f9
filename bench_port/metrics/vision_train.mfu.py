"""vision_train.mfu: as lm_train.mfu, for the vision net (conv and
inner-product FLOPs, 3x the forward)."""

from bench_port.metrics._common import train_mfu


def read(rec):
    return train_mfu(rec, "vision")
