"""Inference engine of the port: bucketed generate/predict over
left-padded micro-batches, and the two continuous-batching programs
over a paged KV cache, each a CUDA graph on the card.

Port of `singa_tpu/serve/engine.py`: `ServeSpec` (`:62-258`), the
left-pad mask (`:261-270`), the bucket programs (`:602-654`), the cb
programs (`:657-802`), `warmup` (`:846-865`), the `engine.stall` site
(`:879-892`), the per-call key (`:894-901`) and `run_batch`
(`:903-931`).  The JAX engine AOT-compiles one program per (mode,
bucket) plus the cb prefill and decode step; here each of those is a
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
softmax.  Checkpoint load and hot reload, `health()` and the serving
front ends come with the port of the HTTP server and wire.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.step_graph import StepGraph
from ..device import DeviceLike, params_device, params_dtype, resolve_device
from ..models.generate import (_sample, decode, forward_cached,
                               forward_paged, init_cache, scatter_prefill)
from ..utils import faults
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


class InferenceEngine:
    """Serves `params` on `device` (CUDA unless the caller passes
    device='cpu'): `run_batch` runs one left-padded micro-batch in
    generate or predict mode, `run_cb_prefill` / `run_cb_decode` the
    continuous-batching programs that `ContinuousScheduler` drives.

    `graphs` picks how programs run.  None: as CUDA-graph replays on
    CUDA, eagerly on the CPU.  True: as replays, or raise on the CPU.
    False: eagerly.  `self.graphs` holds the choice.  Thread-safe: one
    program call at a time (seed, copy in, replay, fetch)."""

    def __init__(self, net, spec: ServeSpec, params: Dict[str, torch.Tensor],
                 device: DeviceLike = None,
                 stats: Optional[ServeStats] = None, log_fn=print,
                 graphs: Optional[bool] = None):
        self.net = net
        self.spec = spec
        self.device = resolve_device(device)
        if graphs and self.device.type != "cuda":
            raise ValueError(f"graphs=True needs a CUDA device, not "
                             f"{self.device}")
        self.graphs = graphs is not False and self.device.type == "cuda"
        self.stats = stats if stats is not None else ServeStats()
        self.log = log_fn
        self._params = {k: v.to(self.device) for k, v in params.items()}
        self.params_step = -1           # constructor params, no checkpoint
        self._gen = torch.Generator(device=self.device)
        self._key_counter = 0
        self._lock = threading.Lock()
        self._pool = torch.cuda.graph_pool_handle() if self.graphs else None
        self._programs: Dict[Tuple, Tuple[Callable, Optional[StepGraph]]] = {}
        self._cb_pools: Optional[Pools] = None
        # injected straggler latency (engine.stall / set_stall): a
        # host-side sleep before every program call
        self.stall_s = 0.0

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The served params.  Read ONCE per micro-batch or scheduler
        step and passed to the program calls."""
        return self._params

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

    def _capture(self, key: Tuple, state, inputs) -> None:
        """Capture program `key`'s graph unless it exists (under the
        lock); counts one compile per graph."""
        fn, graph = self._program(key)
        if graph is not None and graph.capture(fn, state, inputs):
            self.stats.count("compiles")
            self.log(f"serve: captured {graph.name} as a CUDA graph"
                     + (f"; its warm-up cloned {graph.clone_bytes} bytes "
                        f"of KV pools" if graph.clone_bytes else ""))

    def _call(self, key: Tuple, state, inputs: Dict[str, np.ndarray]
              ) -> np.ndarray:
        """Run program `key` once on host `inputs` and fetch its output:
        a replay of its graph (captured here if warm-up did not), or an
        eager call.  The generator is seeded first, for this call."""
        self._maybe_stall()
        fn, graph = self._program(key)
        with self._lock:
            if graph is not None:
                # before the seed: the capture's warm-up draws
                self._capture(key, state, inputs)
            self._next_generator()
            if graph is not None:
                out = graph(fn, state, inputs)
            else:
                out = fn(state, {k: torch.from_numpy(np.array(v)).to(
                    self.device) for k, v in inputs.items()})
            return out.cpu().numpy()

    def warmup(self, modes=("generate",)) -> int:
        """Capture every (mode, bucket) program up front; with cb=on the
        generate mode is exactly the two cb programs, whatever the
        bucket list says (predict stays on buckets).  Returns the number
        of graphs captured; afterwards serving never captures again
        (`stats.compiles` stays put).  Eager engines capture nothing."""
        before = self.stats.compiles
        for mode in modes:
            if mode == "generate" and self.spec.cb_on:
                keys = [("cb_prefill",), ("cb_decode",)]
            else:
                keys = [(mode, b, p) for b, p in self.spec.buckets]
            for key in keys:
                _, graph = self._program(key)
                if graph is not None:
                    with self._lock:
                        self._capture(key, self._state(key, self._params),
                                      self._dummy_inputs(key))
        return self.stats.compiles - before

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
        params = self._params if params is None else params
        tokens = np.asarray(tokens, np.int32)
        key = (mode, *tokens.shape)
        out = self._call(key, {"params": params},
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
