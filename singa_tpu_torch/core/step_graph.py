"""Captured steps: the port's counterpart of `jax.jit` with donated buffers.

The JAX package compiles each trainer step into one XLA program that
updates its donated params and optimizer state (`singa_tpu/core/
trainer.py:338-472`) and caches one program per batch geometry
(`compiled_scan`, `:488-520`).  On the card the counterpart is a CUDA
graph: `StepGraph` warms a step function up on a side stream, captures
one call of it into a `torch.cuda.CUDAGraph` over static batch buffers
and the caller's params and state, and replays it.  It keeps one graph
per batch geometry (the path, shape and dtype of every batch leaf) and
caller's `key`: what the step decides on the host (the trainer's
distorting and plain steps, the CD trainer's RBM), where the JAX
package traces a branch or a static argument.

- The step function `fn(state, batch)` works on `state`, a dict of
  (nested dicts of) tensors that every replay reads, and writes in
  place under the top-level keys named in `writes`; it returns its
  outputs, the graph's static outputs, which the next replay
  overwrites.  The same code serves the trainer (params and optimizer
  state written) and the inference engine (params read, paged KV pools
  written).
- Warm-up runs `WARMUP` calls with clones of the written parts of
  `state`, so the caller's step counter, optimizer state or KV pools do
  not move; it also builds and loads the kernels and makes cuBLAS's
  first-call setup, none of which may happen inside a capture.  The
  clones cost one extra copy of the written state while a graph is
  captured (`clone_bytes` holds it).
- Generators that `fn` draws from are registered with every graph
  (`CUDAGraph.register_generator_state`): a replay then reads the
  generator's seed and offset when it runs and advances the offset as
  an eager call does, so a replay after `manual_seed(n)` draws what an
  eager call seeded with n draws.  Warm-up draws from them too, so an
  owner that seeds them per step captures first (`capture`), then
  seeds, then replays.
- A capture that fails raises `CaptureError`, naming the op that broke
  it.  Nothing falls back to running eagerly.  Captures are
  thread-local, so a thread that copies the next batches to the card
  meanwhile (`data.feed.DeviceFeeder`) does not break them.
- `_kernels.LAUNCHES` counts Python calls of the kernel wrappers, and a
  replay makes none: the launches made while capturing are recorded and
  added to the counts at every replay.  Warm-up and capture add nothing
  themselves, and take nothing from what other threads count
  meanwhile: `_kernels.recording` watches the warm-up's side stream
  and the capture's stream.
"""

from __future__ import annotations

import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from ..ops import _kernels

WARMUP = 3


class CaptureError(RuntimeError):
    pass


def _dtype(x) -> torch.dtype:
    """The torch dtype of a tensor or numpy array."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.empty(0, x.dtype)).dtype
    return x.dtype


def geometry(batch, path: str = "") -> Tuple:
    """(path, shape, dtype) of every leaf of a (nested) batch dict."""
    if isinstance(batch, dict):
        return tuple(g for k in sorted(batch)
                     for g in geometry(batch[k], f"{path}/{k}"))
    return ((path, tuple(batch.shape), _dtype(batch)),)


def leaves(tree):
    """The leaves of a (nested) dict, in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k])
    else:
        yield tree


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def copy_batch(dst, src) -> None:
    """Copy a (nested) batch of numpy arrays or tensors into the static
    device buffers `dst`, on the current stream, without a host sync."""
    if isinstance(dst, dict):
        for k in dst:
            copy_batch(dst[k], src[k])
        return
    if isinstance(src, np.ndarray):
        src = torch.from_numpy(src)
    dst.copy_(src, non_blocking=True)


def _culprit(exc: BaseException) -> str:
    """Where in the port the capture broke: the innermost traceback frame
    in singa_tpu_torch outside this module, of `exc` or of the error it
    was raised while handling (ending a broken capture raises anew)."""
    while exc is not None:
        frames = [f for f in traceback.extract_tb(exc.__traceback__)
                  if "singa_tpu_torch" in f.filename
                  and not f.filename.endswith("step_graph.py")]
        if frames:
            f = frames[-1]
            where = f.filename[f.filename.rindex("singa_tpu_torch"):]
            return f"at {where}:{f.lineno} ({f.line})"
        exc = exc.__context__
    return "when the capture ended"


@dataclass
class _Captured:
    graph: torch.cuda.CUDAGraph
    batch: Any                  # static input buffers
    out: Any                    # static outputs
    state_ptrs: Tuple[int, ...]
    launches: Dict[str, int]    # kernel launches per replay


class StepGraph:
    """One step function, captured per batch geometry and replayed.
    `pool` is a `torch.cuda.graph_pool_handle()`: graphs that never run at
    once (a trainer's train and eval steps, an engine's programs) share
    one memory pool.  `writes` names the top-level keys of the state
    that `fn` writes in place; `generators` are the CUDA generators it
    draws from."""

    def __init__(self, name: str, pool, writes: Tuple[str, ...] = (),
                 generators: Tuple[torch.Generator, ...] = ()):
        self.name = name
        self.pool = pool
        self.writes = tuple(writes)
        self.generators = tuple(generators)
        self.clone_bytes = 0
        self._graphs: Dict[Tuple, _Captured] = {}

    def has(self, batch, key: Any = None) -> bool:
        """Whether a graph of `batch`'s geometry and `key` was captured."""
        return (geometry(batch), key) in self._graphs

    def capture(self, fn: Callable, state, batch, key: Any = None) -> bool:
        """Capture `fn` for the geometry of `batch` and `key` unless a
        graph of them exists; True when this call captured."""
        k = (geometry(batch), key)
        if k in self._graphs:
            return False
        self._graphs[k] = self._capture(fn, state, batch)
        return True

    def __call__(self, fn: Callable, state, batch, key: Any = None):
        """Copy `batch` into the graph of its geometry and `key`
        (capturing `fn` on first sight) and replay it on the current
        stream.  `state` must be the tensors the graph was captured
        over.  (`fn` comes with each call, not at construction, so an
        owner that holds this object and whose method `fn` is forms no
        reference cycle.)"""
        key = (geometry(batch), key)
        got = self._graphs.get(key)
        if got is None:
            got = self._graphs[key] = self._capture(fn, state, batch)
        elif tuple(t.data_ptr() for t in leaves(state)) != got.state_ptrs:
            raise ValueError(f"{self.name}: replayed over other state "
                             f"tensors than it was captured over")
        copy_batch(got.batch, batch)
        got.graph.replay()
        _kernels.add_launches(got.launches)
        return got.out

    def _capture(self, fn, state, batch) -> _Captured:
        dev = next(leaves(state)).device
        static = _map(lambda x: torch.empty(tuple(x.shape), dtype=_dtype(x),
                                            device=dev), batch)
        copy_batch(static, batch)
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), _kernels.recording(side):
            warm = {k: _map(lambda t: t.clone(), v) if k in self.writes
                    else v for k, v in state.items()}
            self.clone_bytes = sum(
                t.numel() * t.element_size()
                for k in self.writes if k in warm for t in leaves(warm[k]))
            for _ in range(WARMUP):
                fn(warm, static)
            del warm
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            if not hasattr(graph, "register_generator_state"):
                raise CaptureError(
                    f"{self.name}: this PyTorch cannot register a "
                    f"generator with a CUDA graph, so a replay would "
                    f"repeat one draw")
            graph.register_generator_state(gen)
        # thread-local capture: another thread's CUDA calls (a
        # DeviceFeeder staging the next chunk) neither break the capture
        # nor join it
        ctx = torch.cuda.graph(graph, pool=self.pool,
                               capture_error_mode="thread_local")
        try:
            with _kernels.recording(ctx.capture_stream) as captured, ctx:
                out = fn(state, static)
        except RuntimeError as e:
            raise CaptureError(f"{self.name}: CUDA graph capture failed "
                               f"{_culprit(e)}: {type(e).__name__}: "
                               f"{e}") from e
        return _Captured(graph, static, out,
                         tuple(t.data_ptr() for t in leaves(state)),
                         {k: n for k, n in captured.items() if n})
