"""The rate sweep that places a serving cell's fixed rate.

    python3 bench_port/sweep.py --workload <serving cell> --seed <n> \
        --seconds <s> --rates 8,12,16,...

One set-up, then one window per rate, in the order given, each drained
before the next.  Per rate it prints one JSON line: what the cell's run
would report (`drivers.serve.summarize`) plus the backlog: the queue
waits of the first and the last third of the window's requests, and
the requests not yet prefilled when the window closed.  A rate the
system sustains ends its window with no backlog and its last third
waiting no longer than its first.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", required=True)
    args = p.parse_args(argv)
    import torch
    from bench_port import harness, traffic
    from bench_port.drivers import serve
    bench = harness.benchmark()
    _, cell, cfg = harness.cell_files(bench, args.workload)
    device = torch.device("cuda")
    eng, sched, mark = serve.build(cfg, cell, args.seed, device)
    sched.start()
    try:
        warm = traffic.schedule(cell["load"], cell["warm_s"], args.seed + 1,
                                cfg["vocab_size"])
        serve._serve(sched, warm, cell["warm_s"], cell["drain_s"],
                     mark=mark)
        for i, rate in enumerate(float(r) for r in args.rates.split(",")):
            reqs = traffic.schedule(cell["load"], args.seconds,
                                    args.seed + 10 + i, cfg["vocab_size"],
                                    rate=rate)
            got = serve._serve(sched, reqs, args.seconds, cell["drain_s"],
                               mark=mark)
            s = serve.summarize(cfg, reqs, got, eng.spec.cb_slots)
            waits = [traffic.tokens(r)[0][1] - r.due_at for r in reqs
                     if traffic.tokens(r)]
            third = max(1, len(waits) // 3)
            behind = sum(1 for r in reqs if not traffic.tokens(r)
                         or traffic.tokens(r)[0][1] > got["t_close"])
            print(json.dumps({
                "rate_rps": rate, **{k: v for k, v in s.items()},
                "tokens_per_s": s["streamed"] / s["window_s"],
                "wait_first_third_s": statistics.median(waits[:third]),
                "wait_last_third_s": statistics.median(waits[-third:]),
                "not_prefilled_at_close": behind}), flush=True)
    finally:
        sched.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
