"""Multi-process bootstrap: the reference's hostfile launch on
`torch.distributed`.

Port of `singa_tpu/parallel/bootstrap.py`.  The reference launches the
singa binary once per process with `-procsID=$i -hostfile=<file>`
(examples/mnist/run.sh:20-37); each process reads the hostfile to learn
its peers.  The port keeps that launch surface exactly: the first
hostfile line is the coordinator, `host:port` on it overrides the
cluster config's `start_port` (default `DEFAULT_PORT`), and a hostfile
of one line is a single-process run.  Every process then joins one
gloo process group (`tcp://<coordinator>` rendezvous).  Gloo is the
backend on the CPU and on the card alike: several processes share one
card there, which NCCL refuses, so a collective over CUDA tensors is
staged through the host by its caller (`parallel/partition.py`,
`parallel/elastic.py`).

The JAX package's environment overrides drive this one too, so one
launch script starts either package: JAX_COORDINATOR_ADDRESS,
JAX_NUM_PROCESSES and JAX_PROCESS_ID win when set.

`parse_hostfile` also gives `serve.fleet.EngineFleet.from_hostfile` its
membership.
"""

from __future__ import annotations

import os
from typing import List, Optional

DEFAULT_PORT = 6723  # ClusterProto.start_port default (cluster.proto:7)


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


def coordinator_address(hosts: List[str], port: int = DEFAULT_PORT) -> str:
    """Coordinator = first hostfile entry; its `host:port` spelling wins
    over `port`."""
    if not hosts:
        raise ValueError("empty hostfile")
    head = hosts[0]
    if ":" in head:
        return head
    return f"{head}:{port}"


def distributed_init(procs_id: int = 0,
                     hostfile: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     port: int = DEFAULT_PORT) -> bool:
    """Join the gloo process group from the reference's launch
    coordinates.

    Returns True when a group of several processes was initialized, False
    for the single-process fast path (no hostfile and no process count,
    or one process) — as a 1-line hostfile run of the reference is one
    process.  Environment overrides win when set: JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID."""
    env_num = os.environ.get("JAX_NUM_PROCESSES")
    env_pid = os.environ.get("JAX_PROCESS_ID")
    if env_num is not None:
        num_processes = int(env_num)
    if env_pid is not None:
        procs_id = int(env_pid)
    if hostfile is None and num_processes is None:
        return False
    if hostfile is not None:
        hosts = parse_hostfile(hostfile)
        if num_processes is None:
            num_processes = len(hosts)
        coord = os.environ.get("JAX_COORDINATOR_ADDRESS") or \
            coordinator_address(hosts, port)
    else:
        coord = os.environ.get("JAX_COORDINATOR_ADDRESS")
        if coord is None:
            raise ValueError(
                "num_processes given without hostfile; set "
                "JAX_COORDINATOR_ADDRESS or pass a hostfile")
    if not 0 <= procs_id < num_processes:
        raise ValueError(
            f"procsID {procs_id} out of range for {num_processes} processes")
    if num_processes == 1:
        return False
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://{coord}",
                            world_size=num_processes, rank=procs_id)
    return True


def process_index() -> int:
    """This process's rank in the group (0 without one)."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes in the group (1 without one)."""
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def distributed_shutdown() -> None:
    """Leave the process group, if this process joined one."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
