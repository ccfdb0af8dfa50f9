"""lm_train.device_idle: 100 x (1 - the union of device activity over
the traced span), for the LM train cells."""

from bench_port.metrics._common import family, idle_share


def read(rec):
    return idle_share(rec) if family(rec) == "lm" and "steps" in rec \
        else None
