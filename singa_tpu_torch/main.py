"""CLI entry point of the port: the `serve` subcommand.

Port of the `serve` subcommand of `singa_tpu/main.py` (`:163-371`, with
`_obs_enable` `:138-160` and `_serve_vocab` `:470`):

    python -m singa_tpu_torch.main serve -model_conf lm.conf \\
        --workspace ws [--port 8000] [--serve_spec 'buckets=4x16/8x32,...']

builds the inference net from the model config, serves the latest
healthy checkpoint of the workspace (npz, written by either package's
`CheckpointManager`) on the card, follows the workspace (hot reload),
and serves /generate, /predict, /stats, /metrics, /healthz, /trace and
/admin/reload over stdlib HTTP and, with `--wire`, the binary framed
transport.  With `cb=on` in the serve spec, /generate runs continuous
batching over a paged KV cache and streams tokens when the request body
carries `"stream": true`.  `--smoke N` serves N synthetic in-process
requests, prints the stats snapshot as JSON and exits.

The CLI runs on the card and has no device flag; `main(argv,
device="cpu")` is the Python entry that runs it on the CPU.  The fleet
flags (`--fleet`, `--fleet_hostfile`, `--standby`, `--autoscale_spec`,
`--fleet_spec`, `--rollout_spec`, `--transport`) exit 2: the router and
fleet are ROADMAP.md A11.  Every other subcommand (training, `pipeline`)
exits 2: ROADMAP.md A10.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from . import obs
from .config import load_model_config
from .core.trainer import Trainer
from .data.discovery import discover_input_shapes
from .device import DeviceLike, resolve_device

# flags of the JAX CLI's fleet branch, which waits for the Router
_FLEET_FLAGS = ("fleet", "fleet_hostfile", "standby", "autoscale_spec",
                "fleet_spec", "rollout_spec", "transport")


def _add_obs_flags(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--obs", choices=("on", "off"), default="off",
                    help="unified telemetry: span tracing (Chrome "
                         "trace JSON, Perfetto-loadable), a metrics "
                         "registry, and a structured JSONL event log "
                         "(see docs/OBSERVABILITY.md); artifacts "
                         "default under <workspace>/obs/")
    ap.add_argument("--obs_spec", default=None,
                    help="telemetry config: comma-separated key=value "
                         "over the ObsSpec fields, e.g. "
                         "'trace=/tmp/t.json,events=/tmp/e.jsonl,"
                         "metrics_period_s=5,trace_ring=65536,"
                         "process=worker-0,flightrec=/tmp/fr' "
                         "(singa_tpu_torch/obs/__init__.py)")


def _obs_enable(args, workspace=None) -> bool:
    """Arm the process-global telemetry session from --obs/--obs_spec.
    Bare `--obs on` defaults every artifact under `<workspace>/obs/`
    (`./obs/` without a workspace).  Returns True when a session was
    installed — the caller owns the matching `obs.disable()`."""
    if args.obs != "on":
        if args.obs_spec:
            obs.get_logger("main")("warning: --obs_spec given with "
                                   "--obs off; telemetry stays "
                                   "disabled")
        return False
    spec = obs.ObsSpec.parse(args.obs_spec)
    base = os.path.join(workspace or ".", "obs")
    if not spec.trace:
        spec.trace = os.path.join(base, "trace.json")
    if not spec.events:
        spec.events = os.path.join(base, "events.jsonl")
    if not spec.flightrec:
        spec.flightrec = os.path.join(base, "flightrec")
    obs.enable(spec)
    return True


def make_serve_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="singa_tpu_torch serve",
        description="inference serving on the card: micro-batched "
                    "bucket programs (CUDA graphs) or continuous "
                    "batching, with checkpoint hot reload")
    ap.add_argument("-model_conf", "--model_conf", required=True)
    ap.add_argument("--workspace", default=None,
                    help="checkpoint workspace to serve from and "
                         "hot-reload against (the trainer's "
                         "workspace); omit to serve fresh-init params")
    ap.add_argument("--serve_spec", default=None,
                    help="serving config: comma-separated key=value "
                         "over the ServeSpec fields, buckets as BxP "
                         "'/' entries, e.g. 'buckets=1x16/4x32,"
                         "max_new_tokens=32,eos_id=2'; cb=on enables "
                         "continuous batching with streaming POST "
                         "/generate (singa_tpu_torch/serve/engine.py)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000,
                    help="HTTP port (0 = ephemeral)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", type=int, default=0, metavar="N",
                    help="serve N synthetic in-process requests, print "
                         "the stats snapshot as JSON, and exit (no "
                         "listener)")
    ap.add_argument("--tenant_spec", default=None,
                    help="multi-tenant QoS envelopes: ';'-separated "
                         "tenants, each 'name,key=value,...' over the "
                         "TenantSpec fields "
                         "(singa_tpu_torch/serve/tenancy.py)")
    ap.add_argument("--pinned", action="store_true",
                    help="never self-reload; only POST /admin/reload "
                         "moves the served params")
    ap.add_argument("--wire", action="store_true",
                    help="start the binary framed listener beside HTTP "
                         "(ephemeral port unless --wire_port); "
                         "/healthz advertises it")
    ap.add_argument("--wire_port", type=int, default=0,
                    help="binary transport port (0 = ephemeral; "
                         "implies --wire when nonzero)")
    ap.add_argument("--fault_spec", default=None,
                    help="deterministic fault injection over the serve.* "
                         "sites (singa_tpu_torch/utils/faults.py)")
    lacking = "not in the port yet (ROADMAP.md A11)"
    ap.add_argument("--fleet", type=int, default=0, metavar="N",
                    help=lacking)
    ap.add_argument("--standby", action="store_true", help=lacking)
    for flag in ("fleet_hostfile", "autoscale_spec", "fleet_spec",
                 "rollout_spec", "transport"):
        ap.add_argument(f"--{flag}", default=None, help=lacking)
    _add_obs_flags(ap)
    return ap


def _serve_vocab(net) -> int:
    for layer in net.layers.values():
        for attr in ("vocab_size", "vocab"):
            v = getattr(layer, attr, None)
            if isinstance(v, int) and v > 1:
                return v
    return 256


def serve_main(argv, device: DeviceLike = None) -> int:
    """The `serve` subcommand: build the inference net from the model
    config, load the latest healthy checkpoint, and serve on `device`
    (CUDA unless the caller passes device='cpu')."""
    args = make_serve_argparser().parse_args(argv)
    fleet = [f for f in _FLEET_FLAGS if getattr(args, f)]
    if fleet:
        print(f"error: --{fleet[0]} needs the serving fleet and router, "
              f"which the port does not have yet (ROADMAP.md A11)",
              file=sys.stderr)
        return 2
    dev = resolve_device(device)
    from .serve import InferenceEngine, InferenceServer, ServeSpec
    from .serve.tenancy import TenantRegistry
    from .utils.faults import FaultSchedule, inject
    schedule = (FaultSchedule.parse(args.fault_spec, seed=args.seed)
                if args.fault_spec else None)
    log = obs.get_logger("serve")
    obs_on = _obs_enable(args, args.workspace)
    try:
        model = load_model_config(args.model_conf)
        input_shapes = discover_input_shapes(model, force_synthetic=True)
        trainer = Trainer(model, input_shapes, log_fn=lambda s: None,
                          device=dev, graphs=False)
        # the inference net: the test phase's when the config defines
        # one, else the train net (same params either way)
        net = trainer.test_net or trainer.train_net
        spec = (ServeSpec.parse(args.serve_spec) if args.serve_spec
                else ServeSpec())
        # fresh-init fallback so a checkpoint-less workspace still
        # serves (engine.load prefers any restorable healthy snapshot)
        fallback = net.init_params(args.seed, device=dev)
        engine = InferenceEngine(net, spec, fallback, device=dev,
                                 workspace=args.workspace, log_fn=log,
                                 pinned=args.pinned)
        reg = obs.registry()
        if reg is not None:
            engine.stats.register_into(reg)
        tenancy = (TenantRegistry.parse(args.tenant_spec)
                   if args.tenant_spec else None)
        with inject(schedule):
            if schedule is not None:
                log(f"fault injection active: {args.fault_spec} "
                    f"(seed {args.seed})")
            wire_on = args.smoke == 0 and (args.wire or args.wire_port > 0)
            server = InferenceServer(engine, host=args.host,
                                     port=args.port,
                                     http=(args.smoke == 0),
                                     tenancy=tenancy, log_fn=log,
                                     wire_on=wire_on,
                                     wire_port=args.wire_port)
            server.start()
            if engine.params_step < 0:
                log("warning: serving fresh-init params (no "
                    "restorable checkpoint in the workspace)")
            try:
                if args.smoke > 0:
                    rng = np.random.default_rng(args.seed)
                    vocab = _serve_vocab(net)
                    cap = (spec.cb_max_prompt_len if spec.cb_on
                           else spec.max_prompt_len)
                    for i in range(args.smoke):
                        plen = int(rng.integers(1, cap + 1))
                        prompt = rng.integers(0, vocab,
                                              plen).astype("int32")
                        out = server.generate(prompt)
                        shape = (f"finish {out['finish']}"
                                 if "finish" in out
                                 else f"bucket {out.get('bucket')}")
                        log(f"smoke {i}: plen={plen} -> "
                            f"{len(out['tokens'])} tokens "
                            f"(step {out['step']}, {shape})")
                    print(json.dumps(server.snapshot()), flush=True)
                    return 0
                while True:
                    time.sleep(3600)
            except KeyboardInterrupt:
                log("serve: shutting down")
                print(json.dumps(server.snapshot()), flush=True)
                return 0
            finally:
                server.stop()
    finally:
        if obs_on:
            obs.disable()


def main(argv=None, device: DeviceLike = None) -> int:
    """`serve` runs; every other subcommand exits 2.  `device` is for
    Python callers (tests pass 'cpu'); the command line runs on the
    card."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "serve":
        return serve_main(argv[1:], device=device)
    what = argv[0] if argv and not argv[0].startswith("-") else "training"
    print(f"error: the port's CLI has only the `serve` subcommand; "
          f"{what!r} is ROADMAP.md A10", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
