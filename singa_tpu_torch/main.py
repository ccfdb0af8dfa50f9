"""CLI entry point of the port: training, and the `serve` subcommand.

Port of `singa_tpu/main.py`.  Training (`make_argparser` `:49-118`,
`main` `:735-755`, `_run` `:758-977`):

    python -m singa_tpu_torch.main -model_conf examples/transformer/lm.conf \
        --synthetic --steps N --workspace ws --max-restarts 2 \
        --fault_spec 'ckpt.save@1:torn' --health on --scan_chunk 8

trains on the card from a model config: shard or LMDB folders from
DataProto.path when they exist locally, else the synthetic source; with
`--max-restarts N` under the `Supervisor` (restore the last valid and
healthy snapshot, replay the data, retry within budgets); with the
numeric-health sentinel (`--health`, `--health_spec`), deterministic
fault injection (`--fault_spec`), checkpoints with verdicts in the
workspace, chunked steps (`--scan_chunk`) fed by a `DeviceFeeder`
(`--feeder`, `--feeder_depth`), the device's fwd/bwd/update split on
every `Time per step` line (`--phase_profile`, one traced eager step:
`Trainer.profile_phases`), and telemetry (`--obs`).  An
`alg: kContrastiveDivergence` config (`examples/mnist/rbm.conf`) trains
its kRBM layers greedily with CD-k (`Trainer.run_cd`).

Serving (the `serve` subcommand, `:163-371`, with `_obs_enable`
`:138-160` and `_serve_vocab` `:470`):

    python -m singa_tpu_torch.main serve -model_conf lm.conf \
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
device="cpu")` is the Python entry that runs it on the CPU.  What the
port does not have yet exits 2, naming its ROADMAP.md item: `-procsID`,
`-hostfile`, a cluster config with more than one async group, and an
elastic/RandomSync run that reaches its first center exchange (A9);
the `pipeline` subcommand (A10); serve's
fleet flags (`--fleet`, `--fleet_hostfile`, `--standby`,
`--autoscale_spec`, `--fleet_spec`, `--rollout_spec`, `--transport`:
A11).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from . import obs
from .config import load_cluster_config, load_model_config
from .core.trainer import Trainer
from .data.discovery import discover_input_shapes
from .device import DeviceLike, resolve_device

# flags of the JAX CLI's fleet branch, which waits for the Router
_FLEET_FLAGS = ("fleet", "fleet_hostfile", "standby", "autoscale_spec",
                "fleet_spec", "rollout_spec", "transport")


def make_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="singa_tpu_torch",
        description="SINGA-capability training runtime on the card")
    # single-dash long flags, gflags style (main.cc:13-18)
    ap.add_argument("-model_conf", "--model_conf", required=True)
    ap.add_argument("-cluster_conf", "--cluster_conf", default=None)
    ap.add_argument("-procsID", "--procsID", type=int, default=0,
                    help="multi-process runs: not in the port yet "
                         "(ROADMAP.md A9)")
    ap.add_argument("-hostfile", "--hostfile", default=None,
                    help="multi-host runs: not in the port yet "
                         "(ROADMAP.md A9)")
    ap.add_argument("-v", type=int, default=0, help="verbosity (glog style)")
    ap.add_argument("--synthetic", action="store_true",
                    help="use a synthetic learnable dataset (no egress env)")
    ap.add_argument("--steps", type=int, default=None,
                    help="override ModelProto.train_steps")
    ap.add_argument("--batchsize", type=int, default=0,
                    help="override every data layer's batchsize")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", action="store_true",
                    help="resume from latest checkpoint in the workspace")
    ap.add_argument("--max-restarts", "--max_restarts", type=int,
                    dest="max_restarts", default=0,
                    help="supervise the run: on a step/pipeline failure "
                         "restore the latest valid checkpoint, replay "
                         "data, and retry with backoff up to N times "
                         "(0 = unsupervised)")
    ap.add_argument("--fault_spec", default=None,
                    help="deterministic fault injection: comma-separated "
                         "site@visit[:kind] entries, e.g. "
                         "'step.train@7:preempt,ckpt.save@1:torn' "
                         "(sites/kinds in singa_tpu_torch/utils/faults.py)")
    ap.add_argument("--health", choices=("on", "off"), default="on",
                    help="numeric-health sentinel: device-side "
                         "grad-norm/param-norm/update-ratio probes in the "
                         "train step, host-side OK/SPIKE/NONFINITE/"
                         "DIVERGED classification, checkpoint verdicts, "
                         "and (under --max-restarts) divergence rescue")
    ap.add_argument("--health_spec", default=None,
                    help="health thresholds + rescue policy: comma-"
                         "separated key=value entries over the "
                         "HealthSpec fields, e.g. 'grad_norm_max=1e4,"
                         "spike_mad=8,patience=3,blame_batches=1,"
                         "lr_backoff=0.5' "
                         "(singa_tpu_torch/utils/health.py)")
    ap.add_argument("--workspace", default=None,
                    help="override ClusterProto.workspace")
    ap.add_argument("--scan_chunk", type=int, default=0,
                    help="run up to N steps between host syncs (CUDA-"
                         "graph replays; cadence events still fire at "
                         "their exact steps)")
    ap.add_argument("--feeder", choices=("auto", "on", "off"),
                    default="auto",
                    help="overlapped host/device feed for the chunked "
                         "loop: a background thread stages the next "
                         "chunk (stack into pinned buffers + copy on a "
                         "side stream) while the current one trains "
                         "(auto = on when scan_chunk > 1 unless "
                         "SINGA_TPU_FEEDER=0)")
    ap.add_argument("--feeder_depth", "--feeder-depth", type=int,
                    dest="feeder_depth", default=0,
                    help="staged chunks the feeder may run ahead "
                         "(0 = SINGA_TPU_FEEDER_DEPTH or 2)")
    ap.add_argument("--phase_profile", action="store_true",
                    help="measure the device fwd/bwd/update split once "
                         "(a profiler trace of one eager step) and report "
                         "it at every display interval (worker.h:91-114 "
                         "parity)")
    _add_obs_flags(ap)
    return ap


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
    """Training, or the `serve` subcommand.  `device` is for Python
    callers (tests pass 'cpu'); the command line runs on the card."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "serve":
        return serve_main(argv[1:], device=device)
    if argv and argv[0] == "pipeline":
        return _lacking("the `pipeline` subcommand", "A10")
    args = make_argparser().parse_args(argv)
    if args.hostfile or args.procsID:
        return _lacking("-procsID/-hostfile (multi-process runs)", "A9")
    from .utils.faults import FaultSchedule, inject
    schedule = (FaultSchedule.parse(args.fault_spec, seed=args.seed)
                if args.fault_spec else None)
    obs_on = _obs_enable(args, args.workspace)
    try:
        if schedule is not None:
            obs.get_logger("main")(
                f"fault injection active: {args.fault_spec} "
                f"(seed {args.seed})")
        with inject(schedule):
            return _run(args, device)
    finally:
        if obs_on:
            obs.disable()


def _lacking(what: str, item: str) -> int:
    print(f"error: {what} is not in the port yet (ROADMAP.md {item})",
          file=sys.stderr)
    return 2


def _run(args, device: DeviceLike) -> int:
    log = obs.get_logger("main")
    model = load_model_config(args.model_conf)
    cluster = (load_cluster_config(args.cluster_conf)
               if args.cluster_conf else None)
    # worker-group topology (cluster.h:49-60): async groups are replicas
    # against a shared center
    if cluster is not None and not cluster.synchronous and \
            cluster.nworkers // max(cluster.nprocs_per_group, 1) > 1:
        return _lacking("a cluster config with more than one async "
                        "worker group", "A9")
    if args.steps is not None:
        model.train_steps = args.steps
    u = model.updater
    if (u is not None and u.sync_frequency > 0
            and (u.param_type == "RandomSync"
                 or (u.param_type == "Elastic" and u.moving_rate > 0))
            and model.train_steps > u.warmup_steps):
        # the JAX trainer would exchange params with a center copy from
        # step warmup_steps on (the elastic tier); training on without
        # it would give another result
        return _lacking(f"the {u.param_type} consistency tier (center "
                        f"exchanges from step {u.warmup_steps})", "A9")
    dev = resolve_device(device)

    # data-layer discovery: real sources are peeked for their record
    # geometry, synthetic mode infers it from the parsers
    if args.batchsize:
        for layer in (model.neuralnet.layer if model.neuralnet else []):
            if layer.data_param:
                layer.data_param.batchsize = args.batchsize
            if layer.seqdata_param:
                layer.seqdata_param.batchsize = args.batchsize
    input_shapes = discover_input_shapes(
        model, force_synthetic=args.synthetic)

    # numeric-health sentinel: probes join the train step only when
    # armed; --health off runs the step without them
    from .utils.health import HealthMonitor, HealthSpec
    health_spec = HealthSpec.parse(args.health_spec)
    health = (HealthMonitor(health_spec, log_fn=obs.get_logger("health"))
              if args.health == "on" else None)
    if args.health == "off" and args.health_spec:
        log("warning: --health_spec given with --health off; the "
            "monitor is disabled and the spec only configures the "
            "supervisor's divergence policy")
    trainer = Trainer(model, input_shapes, log_fn=obs.get_logger("trainer"),
                      device=dev, seed=args.seed, health=health)
    trainer.phase_profile = args.phase_profile
    reg = obs.registry()
    if reg is not None and health is not None:
        health.register_into(reg)

    workspace = args.workspace or (cluster.workspace if cluster else None)
    # an explicit --workspace is a request to checkpoint: default to a
    # final snapshot when the config doesn't set a cadence
    if args.workspace and model.checkpoint_frequency == 0:
        model.checkpoint_frequency = max(model.train_steps, 1)
    train_layer = next(
        (l for l in model.neuralnet.layer
         if l.type in ("kShardData", "kLMDBData", "kSequenceData")
         and "kTrain" not in l.exclude),
        None)
    if train_layer is None:
        bs = 64
    elif train_layer.type == "kSequenceData":
        bs = (train_layer.seqdata_param.batchsize
              if train_layer.seqdata_param else 64)
    else:
        bs = train_layer.data_param.batchsize

    # data source: shard/LMDB folders if the configured path exists
    # locally, else the synthetic source
    from .data import resolve_data_source

    def make_train_iter():
        it, _ = resolve_data_source(
            model, bs, seed=args.seed, force_synthetic=args.synthetic,
            sample_shapes=input_shapes)
        return it

    _, test_factory = resolve_data_source(
        model, bs, seed=args.seed, force_synthetic=args.synthetic,
        sample_shapes=input_shapes)

    if args.resume and not workspace:
        log("warning: --resume given but no workspace configured "
            "(set --workspace or ClusterProto.workspace); "
            "starting from scratch")
    # auto -> None: Trainer.run resolves SINGA_TPU_FEEDER (default on
    # for chunked loops)
    feeder_flag = {"auto": None, "on": True, "off": False}[args.feeder]
    if args.feeder == "on" and args.scan_chunk <= 1:
        log("warning: --feeder on has no effect without "
            "--scan_chunk > 1 (the feeder stages whole chunks)")

    if args.max_restarts > 0:
        # supervised runtime: restore the last valid snapshot and replay
        # on failure (Worker::Resume, worker.cc:65-67)
        from .core.supervisor import Supervisor, TrainingAborted
        sup = Supervisor(trainer, workspace,
                         max_restarts=args.max_restarts,
                         max_divergences=health_spec.max_divergences,
                         blame_batches=health_spec.blame_batches,
                         lr_backoff=health_spec.lr_backoff,
                         log=obs.get_logger("supervisor"))
        try:
            sup.run(make_train_iter, test_iter_factory=test_factory,
                    seed=args.seed, scan_chunk=args.scan_chunk,
                    resume=args.resume, feeder=feeder_flag,
                    feeder_depth=args.feeder_depth)
        except TrainingAborted as e:
            log(f"error: {e}")
            return 1
    else:
        params, opt_state = trainer.init(seed=args.seed)
        start_step = 0
        if args.resume and workspace:
            params, opt_state, start_step = trainer.resume(
                params, opt_state, workspace)
            if start_step > 0:
                log(f"resumed from step {start_step}")
            else:
                log(f"no checkpoint found in {workspace}; "
                    "starting from scratch")
        train_iter = make_train_iter()
        try:
            trainer.run(params, opt_state, train_iter,
                        test_iter_factory=test_factory, seed=args.seed,
                        start_step=start_step, workspace=workspace,
                        scan_chunk=args.scan_chunk, feeder=feeder_flag,
                        feeder_depth=args.feeder_depth)
        finally:
            train_iter.close()
    final = trainer.perf.to_string()
    log("training done" + (f": {final}" if final else
                           f" at step {model.train_steps}"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
