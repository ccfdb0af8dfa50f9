"""Durable session WAL + control-state snapshots: the router's crash
safety (docs/SERVING.md, "Control-plane durability").

`session.py` makes streams survive *engine* death by journaling every token
one hop above the engines — but that journal lived in the router's
memory, so the router itself was still the fleet's single point of
loss: a crash, OOM-kill, or rolling upgrade destroyed every live
stream plus all quarantine/rollout/tenant state.  This module puts
the journal on disk with the same discipline `CheckpointManager`
uses for params:

  * **Write-ahead, group-committed.**  `SessionWal.append_*` is the
    streaming hot path: it coalesces records into an in-memory
    pending list under a lock (microseconds) and a flusher thread
    writes + fsyncs every `group_tokens` records / `group_ms`
    milliseconds — the disk is never on a token's critical path.  A
    failed write degrades to COUNTED lost durability (`wal_lost`,
    fault site `router.wal`); it never blocks or kills a stream.
  * **Torn-tail-tolerant replay.**  Every record is one ndjson line
    carrying a CRC32 of its body.  A SIGKILL mid-write leaves at most
    one torn final line; replay stops at the first unparsable or
    CRC-failing line (counted `torn_tails`) — a torn tail truncates,
    it never poisons the records before it.
  * **Epoch fencing.**  Each router instance claims a monotonically
    increasing epoch (`<dir>/EPOCH`, atomic write) and journals to
    `wal-<epoch>.ndjson` whose header record carries the epoch.  A
    fenced WAL (explicit `fence()` on handoff, or a newer epoch
    observed in the EPOCH file at flush time) refuses all writes
    (`fenced_writes`) so a replaced primary can never corrupt the
    successor's recovery source.

Record kinds (all idempotent under replay):

    header  {"k":"header","epoch":E,"ver":1,"wall":t}
    open    {"k":"open","sid":...,"prompt":[...],"max_new":n,
             "priority":p,"tenant":t,"family":f,"step":s,
             "deadline_rem_s":r}
    tok     {"k":"tok","sid":...,"i":i0,"t":[tokens...]}  (batched;
            duplicates after a crash-between-fsync-and-ack are folded
            by absolute index at replay)
    resume  {"k":"resume","sid":...,"engine":e,"at":n}
    close   {"k":"close","sid":...,"state":st}

`ControlStateStore` snapshots the slow-moving control state
(quarantine benches, rollout phase, tenant Retry-After streaks,
autoscaler cooldowns) to `<dir>/state.json` with the tmp + fsync +
rename discipline; a torn or missing snapshot degrades to empty
state, never a failed start.

The port's own copy of `singa_tpu/serve/sessionlog.py`, JAX-free there
too.  The file formats are the reference's byte for byte, so a WAL or
a control-state file written by either package replays in the other.
"""

from __future__ import annotations

import json
import os
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

from ..utils import faults

WAL_VERSION = 1
EPOCH_FILE = "EPOCH"
STATE_FILE = "state.json"


def _atomic_write(path: str, data: bytes) -> None:
    """tmp + write + flush + fsync + rename — the CheckpointManager
    discipline: a reader sees the old file or the new file, never a
    torn one."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _crc(body: Dict[str, Any]) -> int:
    return zlib.crc32(
        json.dumps(body, sort_keys=True,
                   separators=(",", ":")).encode()) & 0xFFFFFFFF


def _encode(body: Dict[str, Any]) -> bytes:
    return json.dumps({"c": _crc(body), "r": body},
                      separators=(",", ":")).encode() + b"\n"


def wal_path(dir_: str, epoch: int) -> str:
    return os.path.join(dir_, f"wal-{int(epoch):08d}.ndjson")


def read_epoch(dir_: str) -> int:
    """The highest epoch ever claimed under `dir_` (0 = none)."""
    try:
        with open(os.path.join(dir_, EPOCH_FILE)) as f:
            return int(f.read().strip() or 0)
    except (OSError, ValueError):
        return 0


def claim_epoch(dir_: str) -> int:
    """Claim the next epoch (atomic write).  Every router restart or
    standby promotion claims a FRESH epoch — the EPOCH file is the
    fencing token a stale primary's flusher checks itself against."""
    os.makedirs(dir_, exist_ok=True)
    epoch = read_epoch(dir_) + 1
    _atomic_write(os.path.join(dir_, EPOCH_FILE),
                  f"{epoch}\n".encode())
    return epoch


def latest_wal_before(dir_: str, epoch: int) -> Optional[str]:
    """The predecessor's journal: the highest-epoch WAL file strictly
    below `epoch` (the one a restarted/promoted router replays)."""
    best, best_e = None, -1
    try:
        names = os.listdir(dir_)
    except OSError:
        return None
    for n in names:
        if not (n.startswith("wal-") and n.endswith(".ndjson")):
            continue
        try:
            e = int(n[4:-7])
        except ValueError:
            continue
        if best_e < e < int(epoch):
            best, best_e = os.path.join(dir_, n), e
    return best


class WalStats:
    """WAL + recovery counters, exported as `singa_router_*_total`
    (the StreamStats mold)."""

    FIELDS = ("wal_appends", "wal_bytes", "wal_flushes", "wal_lost",
              "fenced_writes", "replayed_sessions",
              "recovered_streams", "torn_tails", "state_snapshots",
              "state_snapshot_failures")

    def __init__(self):
        self._lock = threading.Lock()
        for f in self.FIELDS:
            setattr(self, f, 0)

    def count(self, fieldname: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, fieldname, getattr(self, fieldname) + n)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {f: getattr(self, f) for f in self.FIELDS}

    def register_into(self, registry,
                      prefix: str = "singa_router") -> None:
        from ..obs.metrics import Sample

        def collect():
            snap = self.snapshot()
            return [Sample(f"{prefix}_{k}_total", "counter",
                           f"router WAL counter {k!r}",
                           float(snap[k])) for k in self.FIELDS]

        registry.register_collector(collect)


class SessionWal:
    """Append-only per-router session journal; see module docstring.
    Thread-safe: any number of appenders, one flusher."""

    def __init__(self, dir_: str, epoch: int,
                 group_tokens: int = 64, group_ms: float = 25.0,
                 stats: Optional[WalStats] = None, log_fn=print):
        os.makedirs(dir_, exist_ok=True)
        self.dir = dir_
        self.epoch = int(epoch)
        self.path = wal_path(dir_, epoch)
        self.group_tokens = max(int(group_tokens), 1)
        self.group_ms = max(float(group_ms), 0.0)
        self.stats = stats or WalStats()
        self.log = log_fn
        self._lock = threading.Lock()
        self._pending: List[Dict[str, Any]] = []
        self._pending_n = 0
        self._fenced = False
        self._closed = False
        self._file = open(self.path, "ab")
        self._wake = threading.Event()
        self._stop = threading.Event()
        # header first, synchronously: replay identifies the epoch
        # from the first record even if nothing else ever lands
        self._pending.append({"k": "header", "epoch": self.epoch,
                              "ver": WAL_VERSION,
                              "wall": round(time.time(), 6)})
        self.flush()
        self._flusher = threading.Thread(
            target=self._flush_loop, name=f"wal-{epoch}", daemon=True)
        self._flusher.start()

    @property
    def fenced(self) -> bool:
        return self._fenced

    # -- hot path -----------------------------------------------------------
    def _append(self, body: Dict[str, Any]) -> bool:
        with self._lock:
            if self._fenced or self._closed:
                self.stats.count("fenced_writes")
                return False
            self._pending.append(body)
            self._pending_n += 1
            n = self._pending_n
        self.stats.count("wal_appends")
        if n >= self.group_tokens:
            self._wake.set()
        return True

    def append_open(self, sid: str, prompt, max_new, priority: str,
                    tenant: str, family: Optional[str], step: int,
                    deadline_rem_s: Optional[float]) -> bool:
        return self._append({
            "k": "open", "sid": sid,
            "prompt": [int(t) for t in prompt],
            "max_new": max_new, "priority": priority,
            "tenant": tenant, "family": family, "step": int(step),
            "deadline_rem_s": deadline_rem_s})

    def append_tok(self, sid: str, i: int, token: int) -> bool:
        """One token by absolute index.  Coalesced in the pending
        buffer: consecutive tokens of one sid become ONE `tok`
        record, so the group-committed write is compact."""
        with self._lock:
            if self._fenced or self._closed:
                self.stats.count("fenced_writes")
                return False
            if self._pending:
                last = self._pending[-1]
                if (last.get("k") == "tok" and last["sid"] == sid
                        and last["i"] + len(last["t"]) == int(i)):
                    last["t"].append(int(token))
                    self._pending_n += 1
                    n = self._pending_n
                    self.stats.count("wal_appends")
                    if n >= self.group_tokens:
                        self._wake.set()
                    return True
            self._pending.append({"k": "tok", "sid": sid,
                                  "i": int(i), "t": [int(token)]})
            self._pending_n += 1
            n = self._pending_n
        self.stats.count("wal_appends")
        if n >= self.group_tokens:
            self._wake.set()
        return True

    def append_resume(self, sid: str, engine: str, at: int) -> bool:
        return self._append({"k": "resume", "sid": sid,
                             "engine": engine, "at": int(at)})

    def append_close(self, sid: str, state: str) -> bool:
        return self._append({"k": "close", "sid": sid,
                             "state": state})

    # -- group commit -------------------------------------------------------
    def _flush_loop(self) -> None:
        period = max(self.group_ms / 1e3, 0.001)
        while not self._stop.is_set():
            self._wake.wait(period)
            self._wake.clear()
            self.flush()

    def flush(self) -> None:
        """Write + fsync everything pending (one group commit).  A
        write failure — injected `router.wal` fault or a real disk
        error — drops the batch as COUNTED lost durability and the
        stream keeps serving; durability degrades, tokens never
        block.  Also the fencing checkpoint: a newer epoch in the
        EPOCH file means a successor claimed over us — self-fence."""
        with self._lock:
            batch = self._pending
            n = self._pending_n
            self._pending = []
            self._pending_n = 0
        if not batch:
            return
        if read_epoch(self.dir) > self.epoch:
            with self._lock:
                if not self._fenced:
                    self._fenced = True
                    self.log(f"wal: epoch {self.epoch} fenced (a "
                             f"newer router claimed the journal)")
            self.stats.count("fenced_writes", max(n, 1))
            return
        try:
            faults.maybe_fault("router.wal")
            data = b"".join(_encode(b) for b in batch)
            self._file.write(data)
            self._file.flush()
            os.fsync(self._file.fileno())
            self.stats.count("wal_flushes")
            self.stats.count("wal_bytes", len(data))
        except Exception as e:  # noqa: BLE001 — degrade, never block
            self.stats.count("wal_lost", max(n, 1))
            self.log(f"warning: wal group commit dropped {n} "
                     f"record(s) ({type(e).__name__}: {e}); "
                     f"durability degraded, stream unaffected")

    def fence(self) -> None:
        """Refuse all future writes (handoff: the successor owns the
        journal from here).  Pending records are flushed FIRST so the
        successor's recovery source is complete up to the fence."""
        self.flush()
        with self._lock:
            self._fenced = True

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        self.flush()
        with self._lock:
            self._closed = True
        try:
            self._file.close()
        except OSError:
            pass


# -- replay -----------------------------------------------------------------

def replay_wal(path: str) -> Tuple[Optional[Dict[str, Any]],
                                   List[Dict[str, Any]], bool]:
    """Read a WAL tolerating a torn tail: returns (header record or
    None, body records, torn?).  The first unparsable or CRC-failing
    line truncates the replay — everything before it is trusted,
    nothing after it is read (a torn record never poisons replay)."""
    header: Optional[Dict[str, Any]] = None
    records: List[Dict[str, Any]] = []
    torn = False
    try:
        f = open(path, "rb")
    except OSError:
        return None, [], False
    with f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                body = rec["r"]
                if int(rec["c"]) != _crc(body):
                    raise ValueError("crc mismatch")
            except Exception:  # noqa: BLE001 — torn/corrupt line
                torn = True
                break
            if body.get("k") == "header" and header is None:
                header = body
            else:
                records.append(body)
    return header, records, torn


def reduce_sessions(records: List[Dict[str, Any]]
                    ) -> Dict[str, Dict[str, Any]]:
    """Fold a replayed record stream into per-session state.  Token
    records are applied idempotently by ABSOLUTE index, so a
    duplicate append after a crash-between-fsync-and-ack folds to a
    no-op; `terminal` is the journaled close state (None = the
    session was still live at the crash)."""
    out: Dict[str, Dict[str, Any]] = {}
    for rec in records:
        k, sid = rec.get("k"), rec.get("sid")
        if not sid:
            continue
        if k == "open":
            out[sid] = {
                "sid": sid, "prompt": list(rec.get("prompt") or []),
                "max_new": rec.get("max_new"),
                "priority": rec.get("priority") or "interactive",
                "tenant": rec.get("tenant") or "default",
                "family": rec.get("family"),
                "step": int(rec.get("step", -1)),
                "deadline_rem_s": rec.get("deadline_rem_s"),
                "engine": "", "emitted": [], "resumes": 0,
                "terminal": None}
            continue
        s = out.get(sid)
        if s is None:
            continue              # tok/close for an unjournaled open
        if k == "tok":
            i0, toks = int(rec.get("i", 0)), rec.get("t") or []
            for j, t in enumerate(toks):
                pos = i0 + j
                if pos < len(s["emitted"]):
                    continue      # duplicate append: idempotent fold
                if pos > len(s["emitted"]):
                    break         # gap: keep the contiguous prefix
                s["emitted"].append(int(t))
        elif k == "resume":
            s["resumes"] += 1
            s["engine"] = rec.get("engine") or s["engine"]
        elif k == "close":
            s["terminal"] = rec.get("state") or "done"
    return out


def walcheck(path: str) -> Dict[str, Any]:
    """Offline WAL validation/dump (tools/walcheck.py): replay the
    file and summarize what a recovery would see."""
    header, records, torn = replay_wal(path)
    sessions = reduce_sessions(records)
    live = {sid: s for sid, s in sessions.items()
            if s["terminal"] is None}
    kinds: Dict[str, int] = {}
    for r in records:
        kinds[r.get("k", "?")] = kinds.get(r.get("k", "?"), 0) + 1
    try:
        size = os.path.getsize(path)
    except OSError:
        size = 0
    return {
        "path": path,
        "epoch": (header or {}).get("epoch"),
        "version": (header or {}).get("ver"),
        "bytes": size,
        "records": len(records),
        "by_kind": kinds,
        "torn_tail": torn,
        "sessions": len(sessions),
        "live_sessions": len(live),
        "closed_sessions": len(sessions) - len(live),
        "journaled_tokens": sum(len(s["emitted"])
                                for s in sessions.values()),
        "live": [{"sid": sid, "tokens": len(s["emitted"]),
                  "resumes": s["resumes"], "step": s["step"],
                  "family": s["family"], "tenant": s["tenant"]}
                 for sid, s in sorted(live.items())],
    }


# -- control-state snapshots ------------------------------------------------

class ControlStateStore:
    """Periodic atomic snapshots of the router's slow-moving control
    state (`<dir>/state.json`): quarantine strikes/benches, rollout
    phase + rejected fingerprints, tenant Retry-After streaks,
    autoscaler cooldowns.  `load()` is torn/missing-tolerant — a
    router with no snapshot starts from clean state, never refuses
    to start."""

    def __init__(self, dir_: str, stats: Optional[WalStats] = None):
        os.makedirs(dir_, exist_ok=True)
        self.path = os.path.join(dir_, STATE_FILE)
        self.stats = stats or WalStats()

    def save(self, state: Dict[str, Any]) -> bool:
        try:
            _atomic_write(self.path,
                          json.dumps(state, default=str).encode())
            self.stats.count("state_snapshots")
            return True
        except Exception:  # noqa: BLE001 — snapshot is best-effort
            self.stats.count("state_snapshot_failures")
            return False

    def load(self) -> Optional[Dict[str, Any]]:
        try:
            with open(self.path) as f:
                out = json.load(f)
            return out if isinstance(out, dict) else None
        except (OSError, ValueError):
            return None
