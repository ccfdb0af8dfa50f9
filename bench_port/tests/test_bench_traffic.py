"""The traffic generator: the same work for every seed, in another
order, and the open loop's due-instant clock."""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np

from conftest import ROOT

from bench_port import traffic


def load():
    with open(os.path.join(ROOT, "bench_port/cells/"
                           "mistral7b_l4.serve_chat.json")) as f:
        return json.load(f)["load"]


def test_same_sizes_and_instants_for_every_seed():
    a = traffic.schedule(load(), 30.0, 2 ** 31 + 1, 32000)
    b = traffic.schedule(load(), 30.0, 2 ** 31 + 2, 32000)
    assert len(a) == len(b) == round(load()["rate_rps"] * 30)
    assert [r.due for r in a] == [r.due for r in b]
    assert sorted(len(r.prompt) for r in a) == sorted(len(r.prompt)
                                                      for r in b)
    assert [r.max_new for r in a] == [r.max_new for r in b]
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b]
    assert all(np.all(np.diff([r.due for r in a]) >= 0) for _ in (0,))
    p, o = load()["prompt"], load()["output"]
    assert all(p["lo"] <= len(r.prompt) <= p["hi"] for r in a)
    assert all(o["lo"] <= r.max_new <= o["hi"] for r in a)
    # the drawn medians are the stated ones, within a fifth
    for got, spec in (([len(r.prompt) for r in a], p),
                      ([r.max_new for r in a], o)):
        assert abs(np.median(got) / spec["median"] - 1) < 0.2


class Ticket:
    def __init__(self):
        import queue
        self._q = queue.Queue()
        self._done = threading.Event()


def test_requests_are_timed_from_their_due_instant():
    """A stall in sending delays every request behind it; the delay shows
    as the generator's lateness and in latencies measured from the due
    instant, not from the late send."""
    reqs = [traffic.Request(d, np.zeros(4, np.int32), 2)
            for d in (0.0, 0.05, 0.10, 0.15)]
    sent = []

    def submit(prompt, max_new):
        if not sent:
            time.sleep(0.3)         # the first send stalls
        sent.append(time.perf_counter())
        t = Ticket()
        t._q.put(("tok", 7))       # produced before the stamping begins
        return t
    mark = [0.0]
    loop = traffic.OpenLoop(reqs, submit, mark)
    t_open = time.perf_counter()
    loop.start(t_open)
    loop.join(5.0)
    assert all(abs(r.due_at - t_open - r.due) < 1e-9 for r in reqs)
    assert loop.late[1] >= 0.3 - 0.05 - 0.01 and loop.late[3] >= 0.1
    for r in reqs:
        r.ticket._q.put(("tok", 8))
        toks = traffic.tokens(r)
        assert [t for _, _, t in toks] == [7, 8]
        # time to first token counts the stall: from due, not from send
        assert toks[0][0] - r.due_at >= r.sent - r.due_at >= 0.0
    assert reqs[1].sent - reqs[1].due_at >= 0.2


def test_stamped_queue_keeps_the_prefill_mark():
    mark = [1.5]
    q = traffic.Stamped(mark)
    q.put(("tok", 3))
    mark[0] = 2.5
    q.put(("done", {}))
    assert [m for _, m, _ in q.items] == [1.5, 2.5]
