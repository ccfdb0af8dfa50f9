"""Structured event log (JSONL) and the component logger.

`EventLog` appends one JSON object per line — the machine-readable
sibling of the human log: supervisor restarts/rescues, health
verdicts, reload outcomes, shed counts, and periodic metrics
snapshots all land here as `{"ts": ..., "kind": ..., ...}` records a
dashboard (or the smoke script) can grep without parsing prose.
Every write consults the `obs.emit` fault site and swallows any
failure into `dropped` — a full disk or an injected telemetry fault
drops events, never a training step or a request.

`Logger` is the `obs.log` satellite: a callable drop-in for the
`log_fn=print` plumbing that already threads through Trainer /
Supervisor / CheckpointManager / the serve tier.  It prefixes
`[component]`, infers the level from the established `"warning: ..."`
convention (so existing messages keep their meaning), writes warnings
and errors to stderr, and mirrors warning+ lines into the active
session's event log.  Default output stays human-readable — the
smoke scripts' greps keep matching.

The port's own copy of `singa_tpu/obs/log.py`, which is JAX-free
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import json
import sys
import threading
import time
from typing import Any, Callable, Dict, Optional, TextIO

from ..utils import faults

LEVELS = ("debug", "info", "warning", "error")


class EventLog:
    """Append-only JSONL event sink; see module docstring.

    `max_bytes > 0` bounds the file: when the next line would cross
    the bound, the current file rotates to `<path>.1` (one previous
    generation, overwritten each rotation — disk stays under ~2x the
    bound for a week-long pipeline run) and a fresh file is opened.
    The `written`/`dropped` counters are CUMULATIVE across rotations:
    the flush accounting (`obs.flush` event) must keep adding up no
    matter how many times the file rolled underneath it."""

    def __init__(self, path: str, max_bytes: int = 0):
        import os
        self.path = path
        self.max_bytes = max(int(max_bytes or 0), 0)
        self._lock = threading.Lock()
        self.written = 0
        self.dropped = 0
        self.rotations = 0
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._f: Optional[TextIO] = open(path, "a")
        try:
            self._size = os.path.getsize(path)
        except OSError:
            self._size = 0

    def _rotate_locked(self) -> None:
        """Roll the live file to `<path>.1` and reopen.  Caller holds
        the lock; any failure propagates to emit()'s drop counter."""
        import os
        self._f.close()
        os.replace(self.path, self.path + ".1")
        self._f = open(self.path, "a")
        self._size = 0
        self.rotations += 1

    def emit(self, kind: str, **fields) -> bool:
        """Append one event.  Returns False (drop counted) on any
        failure — injected `obs.emit` faults included."""
        try:
            faults.maybe_fault("obs.emit")
            rec: Dict[str, Any] = {"ts": round(time.time(), 6),
                                   "kind": kind}
            rec.update(fields)
            line = json.dumps(rec, default=str, sort_keys=False)
            with self._lock:
                if self._f is None:
                    raise ValueError("event log closed")
                if (self.max_bytes and self._size > 0
                        and self._size + len(line) + 1
                        > self.max_bytes):
                    self._rotate_locked()
                self._f.write(line + "\n")
                self._f.flush()
                self._size += len(line) + 1
                self.written += 1
            return True
        except Exception:  # noqa: BLE001 — telemetry never kills work
            self.dropped += 1
            return False

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                try:
                    self._f.close()
                except Exception:  # noqa: BLE001
                    pass
                self._f = None


class Logger:
    """Component logger, callable like the `log_fn` it replaces.

    `logger("msg")` infers the level ("warning: ..." → warning, else
    info); `.debug/.info/.warning/.error` set it explicitly.  Output
    format is `[component] msg` on stdout (warning+ on stderr) via
    `sink` — pass `sink` to capture output in tests exactly as a bare
    log_fn would be.  `event_log_for` is resolved per call so a
    logger built at import time starts mirroring warning+ records the
    moment a session is enabled."""

    def __init__(self, component: str,
                 sink: Optional[Callable[..., None]] = None,
                 event_log_for: Optional[
                     Callable[[], Optional[EventLog]]] = None):
        self.component = component
        self._sink = sink
        self._event_log_for = event_log_for

    def __call__(self, msg: str) -> None:
        text = str(msg)
        low = text.lstrip().lower()
        if low.startswith("warning:"):
            self.log("warning", text)
        elif low.startswith("error:"):
            self.log("error", text)
        else:
            self.log("info", text)

    def debug(self, msg: str) -> None:
        self.log("debug", msg)

    def info(self, msg: str) -> None:
        self.log("info", msg)

    def warning(self, msg: str) -> None:
        self.log("warning", msg)

    def error(self, msg: str) -> None:
        self.log("error", msg)

    def log(self, level: str, msg: str) -> None:
        text = f"[{self.component}] {msg}"
        if self._sink is not None:
            self._sink(text)
        elif level in ("warning", "error"):
            print(text, file=sys.stderr)
        else:
            print(text)
        if level in ("warning", "error") and \
                self._event_log_for is not None:
            ev = self._event_log_for()
            if ev is not None:
                ev.emit("log", level=level, component=self.component,
                        msg=str(msg))


class MetricsDumper:
    """Daemon thread dumping a registry snapshot into the event log
    every `period_s` — the training side's periodic exporter (the
    serve tier is pull-based via /metrics instead)."""

    def __init__(self, registry, event_log: EventLog,
                 period_s: float):
        self._registry = registry
        self._events = event_log
        self._period = max(float(period_s), 0.05)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="obs-metrics",
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self._period):
            self._dump()

    def _dump(self) -> None:
        try:
            snap = self._registry.snapshot()
        except Exception:  # noqa: BLE001 — never kill the dumper
            return
        self._events.emit("metrics", metrics=snap)

    def stop(self, final_dump: bool = True) -> None:
        self._stop.set()
        self._thread.join(2.0)
        if final_dump:
            self._dump()
