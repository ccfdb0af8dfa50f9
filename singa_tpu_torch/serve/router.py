"""The router's exception vocabulary that the port's serving modules
raise (`singa_tpu/serve/router.py:71-74`).

`EngineUnavailable` is what `wire.BinaryEngineHandle` raises when an
engine cannot take a request at all, and what `wire.exception_for_error`
returns for an engine-side internal error, as the JAX package's handle
does.  The Router, its engine handles, the fleet and the autoscaler are
ROADMAP.md A11; until then a port engine joins a JAX router over HTTP
or the binary wire.
"""

from __future__ import annotations


class EngineUnavailable(RuntimeError):
    """The chosen engine could not take the request at all (process
    dead, connection refused, handler crashed) — retried on another
    engine and charged to this one as a strike."""
