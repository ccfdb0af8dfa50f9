"""The hostfile of a multi-host launch: one member `host[:port]` per
line, as the reference's `-hostfile` (examples/mnist/hostfile).

The port's own copy of `parse_hostfile` from
`singa_tpu/parallel/bootstrap.py` (JAX-free there too), which
`serve.fleet.EngineFleet.from_hostfile` reads its membership with.  The
rest of that module starts `jax.distributed`; its port is ROADMAP.md A9.
"""

from __future__ import annotations

from typing import List


def parse_hostfile(path: str) -> List[str]:
    """One host per line, '#' comments and blank lines ignored
    (reference hostfile format, examples/mnist/hostfile).

    A duplicate host is rejected — two processes binding the same
    coordinates would produce a membership list whose failures only
    surface later as rendezvous hangs or double-routed traffic — and
    a file with no hosts at all (empty / comments only) is an error
    instead of a silently empty membership."""
    hosts: List[str] = []
    seen = set()
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            host = line.split("#", 1)[0].strip()
            if not host:
                continue
            if host in seen:
                raise ValueError(
                    f"hostfile {path}: duplicate host {host!r} at "
                    f"line {lineno} — every member must be unique")
            seen.add(host)
            hosts.append(host)
    if not hosts:
        raise ValueError(
            f"hostfile {path}: no hosts (file is empty or comments "
            f"only); expected one host[:port] per line")
    return hosts
