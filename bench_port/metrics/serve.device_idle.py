"""serve.device_idle: as lm_train.device_idle, over a traced span of
the serving window."""

from bench_port.metrics._common import idle_share


def read(rec):
    return idle_share(rec) if "serve" in rec else None
