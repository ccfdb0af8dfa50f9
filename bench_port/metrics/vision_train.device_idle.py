"""vision_train.device_idle: as lm_train.device_idle, for the vision
train cells."""

from bench_port.metrics._common import family, idle_share


def read(rec):
    return idle_share(rec) if family(rec) == "vision" else None
