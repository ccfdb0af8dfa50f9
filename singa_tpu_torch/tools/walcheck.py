"""Validate / dump a router session WAL offline.

After a crash (or before promoting a standby) an operator wants to
know what the journal actually holds: which epoch wrote it, whether
the tail is torn (normal after SIGKILL — replay truncates, never
poisons), how many sessions are live vs closed, and which streams a
successor would re-admit.  This wraps `serve.sessionlog.walcheck`
over a WAL file, a `<ws>/router/` directory (newest journal), or a
workspace root.  The port's own copy of `tools/walcheck.py`; the WAL
format is the JAX package's, so it reads either package's journal.

Usage:
    python -m singa_tpu_torch.tools.walcheck <wal-file | router-dir | workspace>
    python -m singa_tpu_torch.tools.walcheck --records <wal-file>
                                        # dump every decoded record

Exit status: 0 on a readable journal (torn tail included — that is a
survivable state, not an error), 1 when no journal is found or the
header itself is unreadable.
"""

import json
import os
import sys

from ..serve.sessionlog import read_epoch, replay_wal, walcheck


def _resolve(path: str):
    """A WAL file, a router dir, or a workspace containing one."""
    if os.path.isfile(path):
        return path
    for d in (path, os.path.join(path, "router")):
        if not os.path.isdir(d):
            continue
        wals = sorted(f for f in os.listdir(d)
                      if f.startswith("wal-") and f.endswith(".ndjson"))
        if wals:
            return os.path.join(d, wals[-1])
    return None


def main(argv) -> int:
    args = [a for a in argv if not a.startswith("--")]
    dump_records = "--records" in argv
    if len(args) != 1:
        print(__doc__.strip(), file=sys.stderr)
        return 1
    wal = _resolve(args[0])
    if wal is None:
        print(f"walcheck: no wal-*.ndjson under {args[0]!r}",
              file=sys.stderr)
        return 1
    summary = walcheck(wal)
    d = os.path.dirname(wal)
    summary["dir_epoch"] = read_epoch(d)
    if summary["epoch"] is not None and \
            summary["dir_epoch"] > summary["epoch"]:
        summary["fenced"] = True      # a successor has claimed over
    print(json.dumps(summary, indent=2))
    if dump_records:
        _, records, _ = replay_wal(wal)
        for r in records:
            print(json.dumps(r))
    return 0 if summary.get("epoch") is not None else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
