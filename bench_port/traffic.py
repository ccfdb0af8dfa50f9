"""The general traffic generator: an open loop of requests made from a
cell's parameters and the run's seed.

Arrivals are a Poisson process at the cell's fixed rate, conditioned on
its count over the window: rate x seconds arrival instants drawn
uniformly from a table seed.  Prompt and output lengths are log-normal
(median, sigma) clipped to [lo, hi], drawn from the same table seed.
Every seed therefore gets the same arrival instants, each with the same
output length, and the same set of prompt lengths; the run's seed
permutes which prompt length arrives when and draws the token ids.  The
same work, in another order: output lengths set the decode work a
request holds its slot for, and so how many tokens fall inside the
window, and stay with their instants.

`OpenLoop` submits each request at its due instant whatever earlier
requests are doing, and times it from that instant, so a stall delays
every request behind it and shows in their latencies; it records how
late it ran itself.  (A copy of the open-loop idea of the port's
`serve/traffic.py`, with the clock moved from the moment a request was
sent to the moment it was due.)
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np


@dataclass
class Request:
    due: float                   # seconds after the window opens
    prompt: np.ndarray           # int32 ids
    max_new: int
    ticket: object = None
    sent: Optional[float] = None     # absolute perf_counter instants
    due_at: Optional[float] = None
    error: Optional[str] = None


def _lengths(rng, n: int, spec: Dict) -> np.ndarray:
    x = rng.lognormal(np.log(spec["median"]), spec["sigma"], n)
    return np.clip(np.rint(x), spec["lo"], spec["hi"]).astype(np.int64)


def schedule(traffic: Dict, seconds: float, seed: int, vocab: int,
             rate: Optional[float] = None) -> List[Request]:
    """The window's requests in due order."""
    rate = traffic["rate_rps"] if rate is None else rate
    n = int(round(rate * seconds))
    table = np.random.default_rng(traffic["table_seed"])
    due = np.sort(table.uniform(0.0, seconds, n))
    plen = _lengths(table, n, traffic["prompt"])
    out = _lengths(table, n, traffic["output"])
    rng = np.random.default_rng(int(seed) % (1 << 63))
    order = rng.permutation(n)
    return [Request(float(d), rng.integers(0, vocab, int(p)).astype(np.int32),
                    int(o))
            for d, p, o in zip(due, plen[order], out)]


class Stamped:
    """Stands in for a stream ticket's event queue: every event the
    producer puts is kept with the instant it was put (and the instant
    `mark` held then, the start of the prefill that produced it)."""

    def __init__(self, mark: List[float]):
        self.items: List[tuple] = []
        self.mark = mark

    def put(self, item) -> None:
        self.items.append((time.perf_counter(), self.mark[0], item))


class OpenLoop:
    """A thread that sends `requests` through `submit(prompt, max_new)` at
    t_open + due, each ticket's events stamped (`Stamped`)."""

    def __init__(self, requests: List[Request], submit: Callable,
                 mark: List[float]):
        self.requests, self.submit, self.mark = requests, submit, mark
        self.late: List[float] = []
        self.t_open: Optional[float] = None
        self._thread = threading.Thread(target=self._run, name="open-loop",
                                        daemon=True)

    def start(self, t_open: float) -> None:
        self.t_open = t_open
        self._thread.start()

    def join(self, timeout: float) -> None:
        self._thread.join(timeout)

    def _run(self) -> None:
        for r in self.requests:
            r.due_at = self.t_open + r.due
            wait = r.due_at - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            r.sent = time.perf_counter()
            self.late.append(r.sent - r.due_at)
            try:
                r.ticket = self.submit(r.prompt, r.max_new)
            except Exception as e:  # noqa: BLE001 — a refused request
                r.error = f"{type(e).__name__}: {e}"
                continue
            stamped = Stamped(self.mark)
            old, r.ticket._q = r.ticket._q, stamped
            while not old.empty():      # put before the swap: stamped now
                stamped.put(old.get_nowait())


def tokens(r: Request) -> List[tuple]:
    """(instant, prefill start, token) of each streamed token."""
    return [(t, m, item[1]) for t, m, item in
            (r.ticket._q.items if isinstance(getattr(r.ticket, "_q", None),
                                             Stamped) else [])
            if item[0] == "tok"]


def finished(r: Request) -> bool:
    return (r.ticket is not None and isinstance(r.ticket._q, Stamped)
            and any(item[0] == "done" for _, _, item in r.ticket._q.items))

