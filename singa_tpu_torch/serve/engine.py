"""Inference engine of the port: bucketed generate/predict over
left-padded micro-batches, and the two continuous-batching programs
over a paged KV cache, each a CUDA graph on the card.

Port of `singa_tpu/serve/engine.py`: `ServeSpec` (`:62-258`), the
left-pad mask (`:261-270`), the params lifecycle — `load`,
`poll_reload`, `reload_to`, `health()` (`:284-599`) — the bucket
programs (`:602-654`), the cb programs (`:657-802`), `warmup`
(`:846-865`), the `engine.stall` site (`:879-892`), the per-call key
(`:894-901`) and `run_batch` (`:903-931`).  The JAX engine
AOT-compiles one program per (mode, bucket) plus the cb prefill and
decode step; here each of those is a
`StepGraph` (core/step_graph.py) on CUDA — captured by `warmup()` (or
at first use), replayed thereafter — and a plain eager call on the CPU
or under `graphs=False`.  `ServeStats.compiles` moves only where a graph
is captured, one per graph, so a warmed engine holds it constant.

- A bucket's generate program is the whole `decode` (prefill, then
  `max_new_tokens - 1` one-token steps, unrolled: for a fixed bucket
  every position is a host constant), with the left-pad mask computed
  inside the graph from the static `plens` buffer.
- The cb prefill runs at fixed (1, P) and reads the last real position
  by a device index; the cb decode step runs at a fixed slot count with
  `tokens`, `ntoks` and `tables` as static buffers filled from numpy
  before each replay.  Both write the engine's KV pools (`cb_pools`) in
  place; only the sampled tokens come back to the host.
- Sampling draws from one generator per engine, seeded before every
  call from (seed, call count) as the JAX engine derives its key, and
  registered with every graph, so a replay draws what an eager call
  draws.
- Graphs read the params and pools they were captured over: replaying
  over other tensors raises.  A failed capture raises `CaptureError`;
  nothing falls back to eager calls.

Variable-length prompts are LEFT-padded to the bucket length with a
per-key validity mask: RoPE rotations are relative, so left-padding
keeps every attended (query, key) distance, the last real prompt token
sits at P-1 in every row, and masked pad keys weigh exactly zero after
softmax.

Hot reload.  The JAX engine swaps a new params tree in with one
attribute store; here the graphs were captured over the live tensors,
so a reload COPIES the restored arrays into them instead:
- every name, shape and stored dtype is checked against the live dict
  first (`_check_geometry`, the reference's `_tree_spec`); a mismatch
  refuses the reload and writes nothing — a half-copied model never
  serves;
- the copy runs under the engine's lock, which a micro-batch
  (`MicroBatcher`) or a whole scheduler iteration (its prefills and its
  decode step) holds through `hold()`, so a batch or an iteration runs
  on one params version from start to end; the copy is finished on the
  device before the lock is released;
- the fresh-init fallback (`reload_to(-1)`) and the params served before
  the last explicit reload are host COPIES, not references, because the
  live tensors change in place.

The degrade contract is the reference's: a failed restore keeps the old
params live (`reload_failures`, fingerprint unchanged so the next poll
retries); a walk-back that lands on the served step is
`reloads_refused`; a poll that races a live writer is `torn_polls`.
One race the reference leaves open is closed here: both packages' saves
rename a snapshot into place before they record its health verdict in
the manifest, and a poll between the two took the snapshot for a
healthy one, so a diverged snapshot could serve until the next poll.
Such a poll is a torn poll now (`CheckpointManager.save_in_flight`).
Each capture runs inside `obs.perf.compile_span`: `warmup()` marks its
mode families warm, so a capture after warmup is a
`perf.recompile_anomaly`.

CostWatch (`:762,843,867-876`): the JAX engine reads each compiled
program's FLOPs off XLA's cost analysis, which a CUDA graph does not
have.  Here each program is counted once, by `utils.flops.
counted_flops` over an eager call on its warm-up inputs before its
capture (the serving programs run none of the ctypes kernels a FLOP
counter cannot see), and harvested into `obs.perf`; `harvest_costs()`
re-records those counts and never captures or counts again.  Every
program call is counted with its seconds from launch to output on the
host (`ServeStats.program_calls`), from which `obs.perf` derives each
program's MFU.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..core.step_graph import StepGraph
from ..device import DeviceLike, params_device, params_dtype, resolve_device
from ..models.generate import (_sample, decode, forward_cached,
                               forward_paged, init_cache, scatter_prefill)
from ..obs import perf
from ..utils import faults
from ..utils.checkpoint import CheckpointManager
from ..utils.flops import counted_flops
from .kvcache import Pools, init_pools
from .stats import ServeStats

MODES = ("generate", "predict")


@dataclass(frozen=True)
class ServeSpec:
    """Serving configuration.  `buckets` is the closed set of captured
    (batch, prompt_len) shapes — every request is padded into one of
    them, so after `warmup()` no program is ever captured again.
    `bucket_for` picks the smallest admissible bucket: fewest padded
    slots first, then shortest prompt padding."""
    buckets: Tuple[Tuple[int, int], ...] = ((1, 16), (4, 16), (8, 32))
    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 0.0
    eos_id: Optional[int] = None
    pad_id: int = 0
    queue_capacity: int = 64
    batch_window_s: float = 0.01
    request_timeout_s: float = 5.0
    reload_poll_s: float = 1.0
    degraded_after: int = 3   # consecutive failed batches -> degraded
    seed: int = 0
    # engine.stall fault site: the host-side sleep the silent "stall"
    # kind latches onto this engine's every program call — the
    # deterministic straggler for the hedging bench
    stall_fault_s: float = 0.25
    # priority-aware brownout (serve/qos.py): under queue pressure
    # admission sheds lowest class first.  best_effort is shed once the
    # queue is `brownout_be_frac` full, batch at `brownout_batch_frac`;
    # interactive sheds only when the queue is actually full
    brownout_be_frac: float = 0.5
    brownout_batch_frac: float = 0.75
    # continuous batching (serve/scheduler.py): cb=on replaces the
    # static generate buckets with a paged-KV slot scheduler.  The
    # captured geometry is (cb_slots, blocks-per-slot, cb_block_len,
    # pool size) ONLY — exactly two programs (prefill + decode step)
    # regardless of traffic mix, so nothing is captured after warmup
    cb: str = "off"           # "on" | "off"
    cb_slots: int = 8         # concurrent decode slots (S)
    cb_block_len: int = 16    # tokens per KV block
    cb_blocks: int = 0        # pool size incl. null block; 0 = auto
    cb_prompt_cap: int = 0    # longest admissible prompt; 0 = widest
                              # bucket prompt_len
    # model family this engine serves: half of the (family, step)
    # serving fingerprint.  Engines advertise it on /healthz, the
    # router dispatches a request's `model` onto matching members
    # only, and a failover resume must match BOTH halves.  Parsed
    # lowercase by the str branch of `parse`
    family: str = "default"
    # token flush batching (serve/wire.py): streamed tokens go out in
    # frames/chunks of up to `flush_tokens`, lingering `flush_ms` for
    # stragglers — on both the binary and HTTP ndjson surfaces.  The
    # first token of a stream always flushes alone (first-token
    # latency is a gated stage).  flush_tokens=1 disables batching
    flush_tokens: int = 8
    flush_ms: float = 4.0

    def __post_init__(self):
        norm = []
        for b in self.buckets:
            bb, pp = int(b[0]), int(b[1])
            if bb < 1 or pp < 1:
                raise ValueError(f"bad bucket {b!r}: batch and "
                                 f"prompt_len must be >= 1")
            norm.append((bb, pp))
        if not norm:
            raise ValueError("ServeSpec needs at least one bucket")
        object.__setattr__(self, "buckets",
                           tuple(sorted(set(norm),
                                        key=lambda c: (c[1], c[0]))))
        if int(self.max_new_tokens) < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{self.max_new_tokens}")
        if int(self.queue_capacity) < 1:
            raise ValueError(f"queue_capacity must be >= 1, got "
                             f"{self.queue_capacity}")
        if int(self.degraded_after) < 1:
            raise ValueError(f"degraded_after must be >= 1, got "
                             f"{self.degraded_after}")
        if self.cb not in ("on", "off"):
            raise ValueError(f"cb must be 'on' or 'off', got "
                             f"{self.cb!r}")
        if int(self.cb_slots) < 1 or int(self.cb_block_len) < 1:
            raise ValueError("cb_slots and cb_block_len must be >= 1")
        if int(self.cb_blocks) < 0 or int(self.cb_prompt_cap) < 0:
            raise ValueError("cb_blocks and cb_prompt_cap must be "
                             ">= 0 (0 = auto)")
        if float(self.stall_fault_s) < 0:
            raise ValueError(f"stall_fault_s must be >= 0, got "
                             f"{self.stall_fault_s}")
        be, ba = (float(self.brownout_be_frac),
                  float(self.brownout_batch_frac))
        if not (0 < be <= ba <= 1):
            raise ValueError(
                f"brownout fractions must satisfy 0 < be_frac <= "
                f"batch_frac <= 1, got be={be} batch={ba}")
        fam = str(self.family).strip().lower()
        if not fam:
            raise ValueError("family must be a non-empty name")
        object.__setattr__(self, "family", fam)
        if int(self.flush_tokens) < 1:
            raise ValueError(f"flush_tokens must be >= 1, got "
                             f"{self.flush_tokens}")
        if float(self.flush_ms) < 0:
            raise ValueError(f"flush_ms must be >= 0, got "
                             f"{self.flush_ms}")

    @property
    def max_prompt_len(self) -> int:
        return max(p for _, p in self.buckets)

    # -- continuous-batching geometry (all derived, all static) -------------
    @property
    def cb_on(self) -> bool:
        return self.cb == "on"

    @property
    def cb_prefill_len(self) -> int:
        """Prefill width P: the prompt cap rounded UP to a
        block multiple (prefill scatters whole blocks)."""
        cap = int(self.cb_prompt_cap) or self.max_prompt_len
        bl = int(self.cb_block_len)
        return -(-cap // bl) * bl

    @property
    def cb_max_prompt_len(self) -> int:
        """Longest admissible prompt under cb (fail-fast bound)."""
        return int(self.cb_prompt_cap) or self.max_prompt_len

    @property
    def cb_blocks_per_slot(self) -> int:
        """Table width T: worst-case blocks one slot can ever hold
        (full prefill + a full generation)."""
        bl = int(self.cb_block_len)
        return -(-(self.cb_prefill_len + int(self.max_new_tokens)) // bl)

    @property
    def cb_pool_blocks(self) -> int:
        """Pool size incl. the null block.  Auto (cb_blocks=0) sizes
        for every slot at worst case — exhaustion then needs an
        explicit smaller cb_blocks (the shed tests use one)."""
        n = int(self.cb_blocks)
        if n == 0:
            n = int(self.cb_slots) * self.cb_blocks_per_slot + 1
        return n

    @property
    def max_batch(self) -> int:
        return max(b for b, _ in self.buckets)

    def bucket_for(self, n: int, prompt_len: int) -> Tuple[int, int]:
        """Smallest admissible bucket for `n` requests whose longest
        prompt is `prompt_len`.  When no bucket holds all `n`, the
        widest admissible one is returned (the caller dispatches a full
        batch and re-queues the overflow)."""
        cands = [c for c in self.buckets if c[1] >= prompt_len]
        if not cands:
            raise ValueError(
                f"prompt_len={prompt_len} exceeds every bucket "
                f"{self.buckets}; admission should have rejected it")
        fit = [c for c in cands if c[0] >= n]
        if fit:
            return min(fit, key=lambda c: (c[0], c[1]))
        return min(cands, key=lambda c: (-c[0], c[1]))

    @classmethod
    def parse(cls, spec: str) -> "ServeSpec":
        """CLI grammar (HealthSpec mold): comma/semicolon-separated
        `key=value`.  Buckets are `/`-separated BxP entries, e.g.
        `"buckets=1x8/4x16,max_new_tokens=8,eos_id=2"`.  `eos_id=none`
        clears the eos."""
        kw: Dict[str, Any] = {}
        types = {f.name: f.type for f in dataclasses.fields(cls)}
        for part in spec.replace(";", ",").split(","):
            part = part.strip()
            if not part:
                continue
            try:
                key, _, val = part.partition("=")
                key, val = key.strip(), val.strip()
                if key not in types:
                    raise ValueError(f"unknown key {key!r}")
                if key == "buckets":
                    kw[key] = tuple(
                        tuple(int(x) for x in item.lower().split("x"))
                        for item in val.split("/") if item)
                elif key == "eos_id":
                    kw[key] = None if val.lower() in ("none", "") \
                        else int(val)
                elif "str" in str(types[key]):
                    kw[key] = val.lower()
                elif "float" in str(types[key]):
                    kw[key] = float(val)
                else:
                    kw[key] = int(val)
            except ValueError as e:
                raise ValueError(f"bad serve spec entry {part!r} "
                                 f"(want key=value): {e}") from e
        return cls(**kw)


def _left_pad_mask(prompt_len: int, max_len: int,
                   plens: torch.Tensor) -> torch.Tensor:
    """(B, max_len) bool: key position j of row i is attendable iff
    j >= prompt_len - plens[i].  Every generated position is attendable
    for all rows."""
    kpos = torch.arange(max_len, device=plens.device)[None, :]
    return kpos >= (prompt_len - plens)[:, None]


def left_pad(prompts: Sequence[Sequence[int]], bucket: Tuple[int, int],
             pad_id: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(tokens (B, P) int32, plens (B,) int32) for up to B prompts in a
    (B, P) bucket, as the JAX batcher packs them: each prompt at the
    right end of its row, unused rows a 1-token dummy."""
    b, p = bucket
    if len(prompts) > b or any(len(r) > p for r in prompts):
        raise ValueError(f"{len(prompts)} prompts do not fit bucket {bucket}")
    tokens = np.full((b, p), pad_id, np.int32)
    plens = np.ones((b,), np.int32)
    for i, r in enumerate(prompts):
        tokens[i, p - len(r):] = r
        plens[i] = len(r)
    return tokens, plens


def _stored_dtype(t: torch.Tensor) -> torch.dtype:
    # checkpoints hold bf16 tensors as f32 (numpy has no bfloat16)
    return torch.float32 if t.dtype == torch.bfloat16 else t.dtype


def _host_copy(params) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in params.items()}


def _owned(params, device: torch.device) -> Dict[str, torch.Tensor]:
    """The engine's own copy of `params` on `device`.  `.to` alone
    returns the caller's tensor when it already lies there, and a
    reload copies into the live tensors: two engines built over one
    dict would then move together."""
    return {k: v.detach().to(device, copy=True) for k, v in params.items()}


class InferenceEngine:
    """Serves params on `device` (CUDA unless the caller passes
    device='cpu'): `run_batch` runs one left-padded micro-batch in
    generate or predict mode, `run_cb_prefill` / `run_cb_decode` the
    continuous-batching programs that `ContinuousScheduler` drives.
    With a `workspace` it loads the latest healthy checkpoint there and
    hot-reloads later ones (see the module docstring); `params` is the
    fallback served when the workspace holds nothing restorable, and at
    least one of the two is needed.  (`params` comes third, before
    `workspace`, as the port's callers pass it.)

    `graphs` picks how programs run.  None: as CUDA-graph replays on
    CUDA, eagerly on the CPU.  True: as replays, or raise on the CPU.
    False: eagerly.  `self.graphs` holds the choice.  `pinned` engines
    (fleet members) never follow the workspace on their own: only
    `reload_to` moves them.  Thread-safe: one program call at a time
    (seed, copy in, replay, fetch) under one re-entrant lock, which
    `hold()` keeps across a whole batch or scheduler iteration and a
    reload's copy takes."""

    def __init__(self, net, spec: ServeSpec,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 device: DeviceLike = None,
                 stats: Optional[ServeStats] = None, log_fn=print,
                 graphs: Optional[bool] = None,
                 workspace: Optional[str] = None, pinned: bool = False):
        if workspace is None and params is None:
            raise ValueError("InferenceEngine needs a checkpoint "
                             "workspace or explicit params")
        self.net = net
        self.spec = spec
        self.device = resolve_device(device)
        if graphs and self.device.type != "cuda":
            raise ValueError(f"graphs=True needs a CUDA device, not "
                             f"{self.device}")
        self.graphs = graphs is not False and self.device.type == "cuda"
        self.stats = stats if stats is not None else ServeStats()
        # CostWatch's MFU reads the program calls `_call` counts
        perf.time_source(self.stats.program_calls)
        self.log = log_fn
        self.ckpt = (CheckpointManager(workspace, log_fn=log_fn,
                                       device=self.device)
                     if workspace is not None else None)
        self._params: Optional[Dict[str, torch.Tensor]] = (
            _owned(params, self.device) if params is not None else None)
        self.params_step = -1           # constructor params, no checkpoint
        # the fresh-init fallback that `reload_to(-1)` restores, and the
        # params served before the last explicit reload: host copies,
        # since the live tensors change in place.  Only an engine that
        # follows a workspace can reload, so only it keeps them.
        self._init_params = (_host_copy(self._params)
                             if self.ckpt is not None
                             and self._params is not None else None)
        self._prev_params: Optional[Dict[str, torch.Tensor]] = None
        self._prev_step: Optional[int] = None
        self._fingerprint: Optional[tuple] = None
        self.pinned = bool(pinned)
        # set by a refused or failed reload (the engine serves stale
        # params), cleared by the next successful one: health() reports it
        self._stale_reason: Optional[str] = None
        # consecutive unexpected deaths of the server's reload poll
        self._poll_death_streak = 0
        # wall time of the last reload's copy into the live tensors
        self.reload_copy_ms: Optional[float] = None
        # CompileWatch scope: a capture after THIS engine's warmup is
        # the anomaly, not one of a sibling engine warming up later
        self._perf_scope = f"engine-{id(self):x}"
        self._gen = torch.Generator(device=self.device)
        self._key_counter = 0
        self._lock = threading.RLock()
        # one reload at a time (the poll thread and /admin/reload)
        self._reload_lock = threading.Lock()
        self._pool = torch.cuda.graph_pool_handle() if self.graphs else None
        self._programs: Dict[Tuple, Tuple[Callable, Optional[StepGraph]]] = {}
        # FLOPs per program key, counted once (`_count`)
        self._flops: Dict[Tuple, Optional[float]] = {}
        self._cb_pools: Optional[Pools] = None
        # injected straggler latency (engine.stall / set_stall): a
        # host-side sleep before every program call
        self.stall_s = 0.0

    def note_poll_death(self) -> int:
        self._poll_death_streak += 1
        return self._poll_death_streak

    def note_poll_ok(self) -> None:
        self._poll_death_streak = 0

    # -- params lifecycle ----------------------------------------------------
    @property
    def params(self) -> Optional[Dict[str, torch.Tensor]]:
        """The live params dict (None before `load()` on an engine built
        from a workspace alone).  Its tensors are what the graphs were
        captured over; a reload copies into them."""
        return self._params

    @contextmanager
    def hold(self):
        """Hold the engine's lock for a whole micro-batch or scheduler
        iteration and yield (params, step): a reload's copy waits until
        the block ends, so the block runs on one params version."""
        with self._lock:
            yield self._params, self.params_step

    def _check_geometry(self, new, step: int) -> None:
        live = self._params
        bad = sorted(set(new) ^ set(live))
        for k in sorted(set(new) & set(live)):
            if (tuple(new[k].shape) != tuple(live[k].shape)
                    or new[k].dtype not in (live[k].dtype,
                                            _stored_dtype(live[k]))):
                bad.append(k)
        if bad:
            raise RuntimeError(
                f"checkpoint step {step} has a different parameter "
                f"geometry than the serving model (params {bad[:4]}); "
                f"refusing the swap")

    def _swap(self, params, step: int) -> None:
        """Serve `params` (numpy arrays or tensors) as step `step`: the
        first load places them on the device; later ones are checked
        against the live tensors' geometry and copied into them under
        the lock, the copy finished on the device before it is
        released."""
        new = {k: v if isinstance(v, torch.Tensor)
               else torch.from_numpy(np.asarray(v))
               for k, v in params.items()}
        if self._params is not None:
            self._check_geometry(new, step)
        with self._lock:
            if self._params is None:
                self._params = _owned(new, self.device)
            else:
                t0 = time.perf_counter()
                for k, v in new.items():
                    self._params[k].copy_(v)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self.reload_copy_ms = (time.perf_counter() - t0) * 1e3
            self.params_step = step
        perf.set_memory_tree("serve_params", self._params,
                             scope=self._perf_scope)

    def load(self) -> int:
        """Initial load: the latest healthy checkpoint (walking back past
        unhealthy or corrupt snapshots), else the constructor params.
        Returns the served step (-1 = constructor params)."""
        if self.ckpt is not None:
            restored = self.ckpt.restore(skip_unhealthy=True)
            self._fingerprint = self.ckpt.fingerprint()
            if restored is not None:
                p, _, step = restored
                self._swap(p, step)
            elif self._params is None:
                raise RuntimeError(
                    f"no restorable healthy checkpoint under "
                    f"{self.ckpt.dir} and no fallback params")
        if self._params is not None:
            perf.set_memory_tree("serve_params", self._params,
                                 scope=self._perf_scope)
        return self.params_step

    def poll_reload(self) -> str:
        """One hot-reload attempt: "reloaded" | "unchanged" | "refused"
        | "failed" ("pinned" on a fleet member).  Never raises and never
        unseats the live params on failure."""
        if self.ckpt is None:
            return "unchanged"
        if self.pinned:
            return "pinned"
        with obs.span("engine.reload") as sp:
            with self._reload_lock:
                outcome = self._poll_reload()
            sp.set(outcome=outcome, step=self.params_step)
        if outcome != "unchanged":
            obs.emit_event("serve.reload", outcome=outcome,
                           step=self.params_step)
        return outcome

    def _poll_reload(self) -> str:
        try:
            faults.maybe_fault("serve.reload")
            torn_before = self.ckpt.torn_polls
            fp = self.ckpt.fingerprint()
            if self.ckpt.torn_polls > torn_before:
                # the poll raced a live writer: no change, retried on
                # the next tick; never a reload off a torn read
                self.stats.count("torn_polls")
                return "unchanged"
            if fp == self._fingerprint:
                return "unchanged"
            if self.ckpt.save_in_flight():
                # the newest snapshot is on disk but its verdict is not:
                # restoring now would take a diverged snapshot for a
                # healthy one; retried on the next tick
                self.stats.count("torn_polls")
                return "unchanged"
            restored = self.ckpt.restore(skip_unhealthy=True)
            if restored is None or restored[2] == self.params_step:
                # nothing newer is healthy: record the fingerprint so
                # the refusal is not retried every tick
                self._fingerprint = fp
                self.stats.count("reloads_refused")
                self._stale_reason = (
                    f"reload refused: newer checkpoint on disk is not "
                    f"healthy/restorable; serving stale step "
                    f"{self.params_step}")
                self.log("serve: reload refused — no newer healthy "
                         f"checkpoint (serving step {self.params_step})")
                return "refused"
            p, _, step = restored
            self._swap(p, step)
            self._fingerprint = fp
            self._stale_reason = None
            self.stats.count("reloads")
            self.log(f"serve: hot-reloaded checkpoint step {step}")
            return "reloaded"
        except Exception as e:  # noqa: BLE001 — degrade, never crash
            # fingerprint NOT updated: the next poll retries
            self.stats.count("reload_failures")
            self._stale_reason = (
                f"reload failed ({type(e).__name__}); serving stale "
                f"step {self.params_step}")
            self.log(f"warning: serve reload failed "
                     f"({type(e).__name__}: {e}); keeping params from "
                     f"step {self.params_step}")
            return "failed"

    def reload_to(self, step: Optional[int] = None,
                  skip_unhealthy: bool = False) -> str:
        """Explicit reload (the fleet rollout's command channel; works on
        a pinned engine): checkpoint `step` (None = latest), by default
        without the healthy-verdict walk-back.  Step -1 restores the
        fresh-init fallback; a step no longer on disk that was served
        just before the current params comes back from memory.  Returns
        "reloaded" | "unchanged" | "refused" | "failed"; never raises and
        never unseats the live params on failure."""
        if self.ckpt is None:
            return "refused"
        with obs.span("engine.reload", target=step) as sp:
            with self._reload_lock:
                outcome = self._reload_to(step, skip_unhealthy)
            sp.set(outcome=outcome, step=self.params_step)
        if outcome != "unchanged":
            obs.emit_event("serve.reload", outcome=outcome,
                           step=self.params_step, target=step)
        return outcome

    def _reload_to(self, step: Optional[int],
                   skip_unhealthy: bool) -> str:
        try:
            faults.maybe_fault("serve.reload")
            if step is not None and int(step) < 0:
                if self._init_params is None:
                    self.stats.count("reloads_refused")
                    self.log("serve: reload to step -1 refused — no "
                             "fresh-init fallback params")
                    return "refused"
                if self.params_step < 0:
                    self._stale_reason = None
                    return "unchanged"
                self._prev_params = _host_copy(self._params)
                self._prev_step = self.params_step
                self._swap(self._init_params, -1)
                self._stale_reason = None
                self.stats.count("reloads")
                self.log("serve: reloaded to fresh-init params "
                         "(step -1)")
                return "reloaded"
            if step is not None and int(step) == self.params_step:
                # already live in memory: disk could only fail
                self._stale_reason = None
                return "unchanged"
            fp = self.ckpt.fingerprint()
            restored = self.ckpt.restore(step=step,
                                         skip_unhealthy=skip_unhealthy)
            if restored is None:
                if (step is not None and self._prev_params is not None
                        and int(step) == self._prev_step):
                    # the snapshot left the disk, but it is what this
                    # engine served just before: swap back from memory
                    prev_p, prev_s = self._prev_params, self._prev_step
                    self._prev_params = _host_copy(self._params)
                    self._prev_step = self.params_step
                    self._swap(prev_p, prev_s)
                    self._fingerprint = fp
                    self._stale_reason = None
                    self.stats.count("reloads")
                    self.log(f"serve: reloaded to step {step} from "
                             f"in-memory previous params (snapshot no "
                             f"longer on disk)")
                    return "reloaded"
                self.stats.count("reloads_refused")
                self._stale_reason = (
                    f"explicit reload to step {step} found nothing "
                    f"restorable; serving stale step {self.params_step}")
                self.log(f"serve: explicit reload to step {step} "
                         f"refused — nothing restorable")
                return "refused"
            p, _, got = restored
            if got == self.params_step:
                self._fingerprint = fp
                self._stale_reason = None
                return "unchanged"
            prev = _host_copy(self._params)
            prev_step = self.params_step
            self._swap(p, got)
            self._prev_params, self._prev_step = prev, prev_step
            self._fingerprint = fp
            self._stale_reason = None
            self.stats.count("reloads")
            self.log(f"serve: reloaded to checkpoint step {got}"
                     + (f" (asked for {step})"
                        if step is not None and got != step else ""))
            return "reloaded"
        except Exception as e:  # noqa: BLE001 — degrade, never crash
            self.stats.count("reload_failures")
            self._stale_reason = (
                f"reload to step {step} failed ({type(e).__name__}); "
                f"serving stale step {self.params_step}")
            self.log(f"warning: explicit reload to step {step} failed "
                     f"({type(e).__name__}: {e}); keeping params from "
                     f"step {self.params_step}")
            return "failed"

    # -- health --------------------------------------------------------------
    def health(self) -> Dict[str, Any]:
        """Liveness verdict for /healthz and a router: degraded when the
        engine is wedged (`spec.degraded_after` consecutive failed
        batches), stale (a refused or failed reload) or its reload poll
        keeps dying."""
        reasons = []
        k = int(self.spec.degraded_after)
        streak = self.stats.consecutive_batch_failures
        if streak >= k:
            reasons.append(f"{streak} consecutive failed batches "
                           f"(threshold {k})")
        if self._stale_reason is not None:
            reasons.append(self._stale_reason)
        if self._poll_death_streak >= k:
            reasons.append(
                f"reload poll died {self._poll_death_streak} times "
                f"in a row (threshold {k}); params may be going "
                f"stale")
        return {"ok": not reasons,
                "status": "ok" if not reasons else "degraded",
                "step": self.params_step,
                "family": self.spec.family,
                "pinned": self.pinned,
                "reasons": reasons}

    @property
    def cb_pools(self) -> Pools:
        """The paged KV pools the cb programs write, allocated at first
        use at the spec's geometry in the params' dtype; the scheduler's
        `PagedKVCache` adopts them."""
        if self._cb_pools is None:
            spec = self.spec
            self._cb_pools = init_pools(self.net, spec.cb_pool_blocks,
                                        spec.cb_block_len,
                                        params_dtype(self._params),
                                        self.device)
        return self._cb_pools

    # -- programs ------------------------------------------------------------
    def _sampling(self) -> Tuple[float, int, float]:
        spec = self.spec
        return float(spec.temperature), int(spec.top_k), float(spec.top_p)

    def _build_generate(self, prompt_len: int) -> Callable:
        net, eos_id, gen = self.net, self.spec.eos_id, self._gen
        max_new = int(self.spec.max_new_tokens)
        max_len = prompt_len + max_new
        sampling = self._sampling()

        def fn(state, inp):
            with torch.no_grad():
                kmask = _left_pad_mask(prompt_len, max_len,
                                       inp["plens"].long())
                return decode(net, state["params"], inp["tokens"], max_new,
                              gen, *sampling, eos_id, max_len, kmask)
        return fn

    def _build_predict(self, batch: int, prompt_len: int) -> Callable:
        net = self.net
        max_len = prompt_len + 1

        def fn(state, inp):
            with torch.no_grad():
                params = state["params"]
                cache = init_cache(net, batch, max_len, params_dtype(params),
                                   params_device(params))
                kmask = _left_pad_mask(prompt_len, max_len,
                                       inp["plens"].long())
                logits, _ = forward_cached(net, params, inp["tokens"], cache,
                                           0, kmask=kmask)
                # left-padding puts every row's last real token at P-1
                return torch.log_softmax(logits[:, -1], dim=-1)
        return fn

    def _build_cb_prefill(self) -> Callable:
        """The prefill at fixed (1, P): the prompt is RIGHT-padded to P
        (the causal mask alone keeps pad keys out of every real query's
        horizon), runs through `forward_cached`, samples the first token
        from the last real position (a device index: `plen - 1`, no host
        read), and scatters the cache into the slot's pool blocks."""
        net, gen, sampling = self.net, self._gen, self._sampling()
        p_len = self.spec.cb_prefill_len

        def fn(state, inp):
            with torch.no_grad():
                params = state["params"]
                cache = init_cache(net, 1, p_len, params_dtype(params),
                                   params_device(params))
                logits, cache = forward_cached(net, params, inp["tokens"],
                                               cache, 0)
                last = logits[0].index_select(
                    0, inp["plen"].long().reshape(1) - 1)
                tok0 = _sample(last, gen, *sampling)
                scatter_prefill(state["pools"], cache, inp["row"])
                return tok0
        return fn

    def _build_cb_decode(self) -> Callable:
        """The decode step at fixed slot count S: every slot advances one
        token against its paged blocks, one `_sample` call draws all S
        next tokens.  Join and retire are host bookkeeping in the
        scheduler; the program never changes shape."""
        net, gen, sampling = self.net, self._gen, self._sampling()

        def fn(state, inp):
            with torch.no_grad():
                logits, _ = forward_paged(net, state["params"],
                                          inp["tokens"][None],
                                          state["pools"], inp["tables"],
                                          inp["ntoks"])
                return _sample(logits[0], gen, *sampling)
        return fn

    def _dummy_inputs(self, key: Tuple) -> Dict[str, np.ndarray]:
        """Inputs of the program's geometry for a capture at warm-up:
        every write they cause lands in the null block."""
        spec = self.spec
        if key[0] == "cb_prefill":
            p = spec.cb_prefill_len
            return {"tokens": np.zeros((1, p), np.int32),
                    "plen": np.array(1, np.int32),
                    "row": np.zeros((p // spec.cb_block_len,), np.int32)}
        if key[0] == "cb_decode":
            s = spec.cb_slots
            return {"tokens": np.zeros((s,), np.int32),
                    "ntoks": np.zeros((s,), np.int32),
                    "tables": np.zeros((s, spec.cb_blocks_per_slot),
                                       np.int32)}
        _, b, p = key
        return {"tokens": np.zeros((b, p), np.int32),
                "plens": np.ones((b,), np.int32)}

    def _program(self, key: Tuple) -> Tuple[Callable, Optional[StepGraph]]:
        got = self._programs.get(key)
        if got is None:
            if key[0] == "cb_prefill":
                fn, writes = self._build_cb_prefill(), ("pools",)
            elif key[0] == "cb_decode":
                fn, writes = self._build_cb_decode(), ("pools",)
            elif key[0] == "generate":
                fn, writes = self._build_generate(key[2]), ()
            elif key[0] == "predict":
                fn, writes = self._build_predict(*key[1:]), ()
            else:
                raise ValueError(f"unknown mode {key[0]!r}; modes are "
                                 f"{MODES}")
            name = key[0] + ("" if len(key) == 1 else f"[{key[1]}x{key[2]}]")
            graph = (StepGraph(name, self._pool,
                               writes=writes, generators=(self._gen,))
                     if self.graphs else None)
            got = self._programs[key] = (fn, graph)
        return got

    def _state(self, key: Tuple, params) -> Dict[str, Any]:
        if key[0].startswith("cb_"):
            return {"params": params, "pools": self.cb_pools}
        return {"params": params}

    def _geometry(self, key: Tuple) -> str:
        spec = self.spec
        if key[0].startswith("cb_"):
            return (f"slots={spec.cb_slots},blocks={spec.cb_pool_blocks},"
                    f"block_len={spec.cb_block_len}")
        return f"b{key[1]}_p{key[2]}"

    def _count(self, key: Tuple) -> None:
        """Count program `key`'s FLOPs once, by an eager call on its
        warm-up inputs (whose writes land in the null block), and harvest
        them under its mode; under the lock."""
        if key in self._flops:
            return
        fn, _ = self._program(key)
        inputs = {k: torch.from_numpy(v).to(self.device)
                  for k, v in self._dummy_inputs(key).items()}
        self._flops[key] = counted_flops(
            fn, self._state(key, self._params), inputs)
        perf.harvest(key[0], flops=self._flops[key])

    def _capture(self, key: Tuple, state, inputs) -> None:
        """Capture program `key`'s graph unless it exists (under the
        lock); counts one compile per graph, timed by CompileWatch in
        this engine's scope (the cb programs in the generate family)."""
        self._count(key)
        fn, graph = self._program(key)
        if graph is None:
            return
        if graph.has(inputs):
            perf.lookup_hit(key[0])
            return
        family = "generate" if key[0].startswith("cb_") else key[0]
        geometry = self._geometry(key)
        with obs.span("engine.compile", mode=key[0], geometry=geometry), \
                perf.compile_span(key[0], geometry=geometry,
                                  scope=self._perf_scope, family=family):
            graph.capture(fn, state, inputs)
        self.stats.count("compiles")
        if key[0].startswith("cb_"):
            perf.set_memory_tree("kv_pool", self.cb_pools,
                                 scope=self._perf_scope)
        self.log(f"serve: captured {graph.name} as a CUDA graph"
                 + (f"; its warm-up cloned {graph.clone_bytes} bytes "
                    f"of KV pools" if graph.clone_bytes else ""))

    def _call(self, key: Tuple, state, inputs: Dict[str, np.ndarray]
              ) -> np.ndarray:
        """Run program `key` once on host `inputs` and fetch its output:
        a replay of its graph (captured here if warm-up did not), or an
        eager call.  The generator is seeded first, for this call.
        Spans `engine.launch` (inputs to the card and the replay's
        enqueue) and `engine.fetch` (the blocking copy of the output);
        `stats.observe_call` counts the call and its seconds from launch
        to output on the host."""
        self._maybe_stall()
        fn, graph = self._program(key)
        with self._lock:
            if graph is not None:
                # before the seed: the capture's warm-up draws
                self._capture(key, state, inputs)
            self._next_generator()
            t0 = time.perf_counter()
            with obs.span("engine.launch", program=key[0]):
                if graph is not None:
                    out = graph(fn, state, inputs)
                else:
                    out = fn(state, {k: torch.from_numpy(np.array(v)).to(
                        self.device) for k, v in inputs.items()})
            with obs.span("engine.fetch", program=key[0]):
                out = out.cpu().numpy()
            self.stats.observe_call(key[0], t0, time.perf_counter())
            if key[0] in ("generate", "cb_prefill"):
                perf.mark_serving_ready()      # first warm token (latch)
            return out

    def warmup(self, modes=("generate",)) -> int:
        """Capture every (mode, bucket) program up front; with cb=on the
        generate mode is exactly the two cb programs, whatever the
        bucket list says (predict stays on buckets).  Returns the number
        of graphs captured; afterwards serving never captures again
        (`stats.compiles` stays put).  Eager engines capture nothing.
        Either way each program's FLOPs are counted first, by one eager
        call (`_count`)."""
        if self._params is None:
            raise RuntimeError("engine has no params; call load()")
        before = self.stats.compiles
        for mode in modes:
            if mode == "generate" and self.spec.cb_on:
                keys = [("cb_prefill",), ("cb_decode",)]
            else:
                keys = [(mode, b, p) for b, p in self.spec.buckets]
            for key in keys:
                with self._lock:
                    self._capture(key, self._state(key, self._params),
                                  self._dummy_inputs(key))
        for mode in modes:
            # from here on a capture in this scope for a warmed mode
            # family is a perf.recompile_anomaly
            perf.mark_warm(self._perf_scope, mode)
        return self.stats.compiles - before

    def harvest_costs(self) -> int:
        """CostWatch sweep: re-record the FLOPs counted so far (every
        warmed program, and each captured at first use).  Reads the
        counts only, never counts or captures again, so `stats.compiles`
        is unchanged.  Returns the programs harvested."""
        with self._lock:
            items = list(self._flops.items())
        for key, flops in items:
            perf.harvest(key[0], flops=flops)
        return len(items)

    # -- execution -----------------------------------------------------------
    def set_stall(self, seconds: float) -> None:
        """Latch `seconds` of host-side sleep onto every program call (0
        clears it); the `engine.stall` fault site latches
        `spec.stall_fault_s` on whichever engine's thread it fires in."""
        self.stall_s = max(float(seconds), 0.0)

    def _maybe_stall(self) -> None:
        kind = faults.maybe_fault("engine.stall")
        if kind == "stall":
            self.stall_s = max(self.stall_s,
                               float(self.spec.stall_fault_s))
        if self.stall_s > 0:
            time.sleep(self.stall_s)

    def _next_generator(self) -> torch.Generator:
        # one stream per call, from (seed, call count) as the JAX engine
        # derives its per-call key
        n = self.spec.seed * 1000003 + self._key_counter
        self._key_counter += 1
        self._gen.manual_seed(n)
        return self._gen

    def run_batch(self, mode: str, tokens: np.ndarray, plens: np.ndarray,
                  params=None) -> np.ndarray:
        """Run one padded micro-batch.  `tokens` (B, P) LEFT-padded with
        spec.pad_id, `plens` (B,) real prompt lengths; `params` is the
        dict the caller read from `self.params` (default: it).  Returns
        (B, max_new_tokens) int32 for generate, (B, V) float32
        next-token log-probs for predict."""
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; modes are {MODES}")
        tokens = np.asarray(tokens, np.int32)
        key = (mode, *tokens.shape)
        # on the dispatch thread this nests under batcher.dispatch and
        # inherits its batch-M correlation id
        with obs.span("engine.run_batch", mode=mode, batch=key[1],
                      plen=key[2]):
            out = self._call(key, {"params": self._params if params is None
                                   else params},
                             {"tokens": tokens,
                              "plens": np.asarray(plens, np.int32)})
        return out.astype(np.int32) if mode == "generate" else out

    def run_cb_prefill(self, params, pools: Pools, tokens: np.ndarray,
                       plen: int, row: np.ndarray) -> Tuple[int, Pools]:
        """One slot prefill: `tokens` (1, P) RIGHT-padded, `row` the first
        P // block_len entries of the slot's block table.  Returns (the
        first sampled token, the pools, written in place); `pools` must
        be `self.cb_pools`."""
        out = self._call(("cb_prefill",), {"params": params, "pools": pools},
                         {"tokens": np.asarray(tokens, np.int32),
                          "plen": np.array(int(plen), np.int32),
                          "row": np.asarray(row, np.int32)})
        return int(out[0]), pools

    def run_cb_decode(self, params, pools: Pools, tokens: np.ndarray,
                      ntoks: np.ndarray, tables: np.ndarray
                      ) -> Tuple[np.ndarray, Pools]:
        """One decode step for all S slots.  Returns ((S,) int32 next
        tokens on the host, the pools, written in place)."""
        out = self._call(("cb_decode",), {"params": params, "pools": pools},
                         {"tokens": np.asarray(tokens, np.int32),
                          "ntoks": np.asarray(ntoks, np.int32),
                          "tables": np.asarray(tables, np.int32)})
        return out.astype(np.int32), pools

    def answer(self, mode: str, prompts: List[Sequence[int]]
               ) -> List[np.ndarray]:
        """Pad `prompts` into their bucket, run them, and return each
        request's own row."""
        bucket = self.spec.bucket_for(len(prompts),
                                      max(len(r) for r in prompts))
        tokens, plens = left_pad(prompts, bucket, self.spec.pad_id)
        out = self.run_batch(mode, tokens, plens)
        return [out[i] for i in range(len(prompts))]
