"""CLI entry point of the port: training, and the `serve` and `pipeline`
subcommands.

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
`CheckpointManager`, or the JAX package's orbax step) on the card,
follows the workspace (hot reload), and serves /generate, /predict,
/stats, /metrics, /healthz, /trace and /admin/reload over stdlib HTTP
and, with `--wire`, the binary framed transport.  With `cb=on` in the serve spec, /generate runs continuous
batching over a paged KV cache and streams tokens when the request body
carries `"stream": true`.  `--smoke N` serves N synthetic in-process
requests, prints the stats snapshot as JSON and exits.

With `--fleet N` (`_fleet_main`, `:374-468`) it serves N pinned engines
on the card behind a `Router` with canary rollout (`--rollout_spec`),
the router's own knobs (`--fleet_spec`), an autoscaler
(`--autoscale_spec`) and a warm standby mode (`--standby`), fronted by
`FleetServer`; `--fleet_hostfile` adopts running `serve --pinned`
workers instead (`--transport auto` negotiates the binary wire per
worker, `http` pins HTTP).

A config whose updater asks for Elastic or RandomSync (the shipped
`examples/mnist/mlp.conf`) exchanges its params with a center copy from
warmup_steps on; with a cluster config of several async worker groups
(`synchronous: false`, nworkers/nprocs_per_group > 1) the groups train
as replicas round-robin against one center (`_replica_groups`,
`:852-900`), and the center is evaluated at the end.

The `pipeline` subcommand (`make_pipeline_argparser`, `pipeline_main`,
`_pipeline_smoke`, `:479-733`):

    python -m singa_tpu_torch.main pipeline -model_conf lm.conf \
        --workspace ws --synthetic --fleet 2 [--smoke N]

runs the supervised trainer beside an `EngineFleet` on one workspace
(`core/pipeline.py`): every health-blessed checkpoint is canaried and
promoted to traffic; `--smoke N` drives N in-process requests while it
trains, waits for blessed == served, prints the pipeline's snapshot and
exits 0 (1 on a failed request, a failed training or a lag left).

Several processes (`_run`, `:758-797`): the reference's launch,

    python -m singa_tpu_torch.main -model_conf conv.conf \
        -cluster_conf cluster.conf -hostfile hostfile -procsID $i

joins one gloo process group per run (`parallel/bootstrap.py`; the
first hostfile line is the coordinator, `start_port` its port unless
the line says `host:port`; a one-line hostfile is a single-process
run).  With more than one process the cluster config's mesh spans the
group (`parallel/mesh.py`): its data axis (`data_parallel: N`, or the
legacy worker groups under kDataPartition or kNone), its model axis
(`tensor_parallel: N`, or kLayerPartition over a group of several
executors), its seq axis (`sequence_parallel: N`), its pipe axis
(`pipeline_parallel: N`: a net with `locationid` stages runs as a GPipe
schedule, or the circular one where the stages are a multiple of N,
with `pipeline_microbatches` microbatches, 2·N by default) and its
expert axis (`expert_parallel: N`: kMoE's experts split over N ranks),
in any combination: a pipe axis beside a model, seq or expert axis runs
the stages whole on those ranks and the pre and post groups over them,
as the JAX package does.  `alg: kContrastiveDivergence` (rbm.conf)
trains over a data axis too, each rank running the chain on its rows.
Every process builds the same global batch and trains on its part, with
its shards of the params and optimizer state, gradients averaged over
the data × seq ranks (`parallel/partition.py`, `parallel/sequence.py`,
`parallel/pipeline_net.py`, `ops/moe.py`); such a run is eager.  Only
rank 0 writes checkpoints, whole, so the processes must
share one workspace: `--resume` fails on every rank, naming each rank's
step, where the ranks took up different states.  A mesh that does not
fit the process count raises, and a cluster config's mesh over one
process is not used, as in the JAX CLI.

The JAX package's orbax steps are read by the port's own OCDBT, zarr
and zstd reader (`utils/checkpoint.py`; on the card its native zstd
decoder), so a workspace a TPU user trained resumes and serves here.  A
step in a format that reader does not understand ends any subcommand
with exit 1 and the reason, never a run from step 0.  The CLI runs on the card and has no device flag;
`main(argv, device="cpu")` is the Python entry that runs it on the CPU.
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

def make_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="singa_tpu_torch",
        description="SINGA-capability training runtime on the card")
    # single-dash long flags, gflags style (main.cc:13-18)
    ap.add_argument("-model_conf", "--model_conf", required=True)
    ap.add_argument("-cluster_conf", "--cluster_conf", default=None)
    ap.add_argument("-procsID", "--procsID", type=int, default=0,
                    help="this process's id in a -hostfile launch")
    ap.add_argument("-hostfile", "--hostfile", default=None,
                    help="one host[:port] per line, the first the "
                         "coordinator; one line per process")
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
    ap.add_argument("--fleet", type=int, default=0, metavar="N",
                    help="serving fleet: N in-process pinned engines "
                         "behind a health-driven router with canary "
                         "rollout and rollback")
    ap.add_argument("--fleet_hostfile", default=None,
                    help="adopt running `serve --pinned` workers "
                         "instead: one host[:port] per line; mutually "
                         "exclusive with --fleet")
    ap.add_argument("--fleet_spec", default=None,
                    help="router config: comma-separated key=value over "
                         "the RouterSpec fields, e.g. 'probe_period_s="
                         "0.25,quarantine_after=2' "
                         "(singa_tpu_torch/serve/router.py)")
    ap.add_argument("--rollout_spec", default=None,
                    help="rollout config: comma-separated key=value over "
                         "the RolloutSpec fields, e.g. 'window_s=2,"
                         "min_requests=10' (singa_tpu_torch/serve/"
                         "fleet.py)")
    ap.add_argument("--autoscale_spec", default=None,
                    help="the SLO-driven autoscaler over the fleet: "
                         "comma-separated key=value over the "
                         "AutoScaleSpec fields, e.g. 'min_engines=1,"
                         "max_engines=4' (singa_tpu_torch/serve/"
                         "autoscale.py; grows only a --fleet fleet)")
    ap.add_argument("--standby", action="store_true",
                    help="start the fleet router as a warm standby over "
                         "the primary's --workspace: the data plane "
                         "stays 503 until POST /admin/promote (needs "
                         "--fleet or --fleet_hostfile)")
    ap.add_argument("--transport", default="auto",
                    choices=("auto", "http"),
                    help="data plane of adopted (hostfile) workers: "
                         "auto = the binary wire where /healthz "
                         "advertises it, with HTTP fallback; http = "
                         "HTTP only")
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
    if args.fleet and args.fleet_hostfile:
        print("error: --fleet and --fleet_hostfile are mutually "
              "exclusive (spawn a fleet OR adopt one)", file=sys.stderr)
        return 2
    if args.standby and not (args.fleet or args.fleet_hostfile):
        print("error: --standby is a fleet-router mode (needs --fleet "
              "or --fleet_hostfile)", file=sys.stderr)
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
        if args.fleet or args.fleet_hostfile:
            return _fleet_main(args, net, spec, fallback, schedule, log,
                               dev)
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


def _fleet_main(args, net, spec, fallback, schedule, log, dev) -> int:
    """The fleet branch of `serve`: N pinned engines behind a `Router`
    and a `RolloutController`, fronted by `FleetServer` (or driven in
    process under --smoke)."""
    from .serve import (AutoScaler, AutoScaleSpec, EngineFleet,
                        FleetServer, RolloutSpec, RouterSpec)
    from .serve.tenancy import TenantRegistry
    from .utils.faults import inject
    router_spec = RouterSpec.parse(args.fleet_spec)
    rollout_spec = RolloutSpec.parse(args.rollout_spec)
    autoscale_spec = (AutoScaleSpec.parse(args.autoscale_spec)
                      if args.autoscale_spec is not None else None)
    tenancy = (TenantRegistry.parse(args.tenant_spec)
               if args.tenant_spec else None)
    if args.pinned:
        log("warning: --pinned is a member flag; the fleet's workers "
            "are always pinned — ignoring")
    with inject(schedule):
        if schedule is not None:
            log(f"fault injection active: {args.fault_spec} "
                f"(seed {args.seed})")
        if args.fleet_hostfile:
            fleet = EngineFleet.from_hostfile(
                args.fleet_hostfile, workspace=args.workspace,
                router_spec=router_spec, rollout_spec=rollout_spec,
                tenancy=tenancy, standby=args.standby, log_fn=log,
                transport=args.transport)
        else:
            fleet = EngineFleet.local(
                net, spec, args.fleet, workspace=args.workspace,
                params=fallback, router_spec=router_spec,
                rollout_spec=rollout_spec, tenancy=tenancy,
                standby=args.standby, log_fn=log, device=dev)
        scaler = None
        if autoscale_spec is not None and args.standby:
            log("warning: --autoscale_spec ignored on a standby router "
                "(no traffic signal to scale on until promote)")
        elif autoscale_spec is not None:
            if not fleet.can_grow():
                log("warning: --autoscale_spec on an adopted (hostfile) "
                    "fleet can only scale DOWN — spawning remote "
                    "workers is deployment's job")
            scaler = AutoScaler(fleet, spec=autoscale_spec, log_fn=log)
            # cooldown and streak survive a router restart
            fleet.add_state_provider("autoscale", scaler.export_state,
                                     scaler.restore_state)
        reg = obs.registry()
        if reg is not None:
            fleet.router.stats.register_into(reg)
            if scaler is not None:
                scaler.register_into(reg)
        fleet.start()
        if scaler is not None:
            scaler.start()
        try:
            if args.smoke > 0:
                rng = np.random.default_rng(args.seed)
                vocab = _serve_vocab(net)
                cap = (spec.cb_max_prompt_len if spec.cb_on
                       else spec.max_prompt_len)
                for i in range(args.smoke):
                    plen = int(rng.integers(1, cap + 1))
                    prompt = rng.integers(0, vocab, plen).astype("int32")
                    out = fleet.generate(prompt)
                    log(f"smoke {i}: plen={plen} -> "
                        f"{len(out['tokens'])} tokens on "
                        f"{out['engine']} (step {out['step']})")
                snap = fleet.snapshot()
                if scaler is not None:
                    snap["autoscale"] = scaler.snapshot()
                print(json.dumps(snap), flush=True)
                return 0
            front = FleetServer(fleet, host=args.host, port=args.port,
                                log_fn=log)
            front.start()
            try:
                while True:
                    time.sleep(3600)
            except KeyboardInterrupt:
                log("fleet: shutting down")
                print(json.dumps(fleet.snapshot()), flush=True)
                return 0
            finally:
                front.stop()
        finally:
            if scaler is not None:
                scaler.stop()
            fleet.stop()


def make_pipeline_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="singa_tpu_torch pipeline",
        description="closed-loop train-and-serve on the card: "
                    "a supervised trainer and a serving fleet run "
                    "concurrently against ONE workspace — every "
                    "health-blessed checkpoint is canaried and "
                    "promoted to traffic within bounded lag, and a "
                    "DIVERGED step is never served by more than the "
                    "canary")
    ap.add_argument("-model_conf", "--model_conf", required=True)
    ap.add_argument("--workspace", required=True,
                    help="the shared checkpoint workspace — the "
                         "trainer publishes into it, the fleet "
                         "promotes out of it")
    ap.add_argument("--steps", type=int, default=None,
                    help="override ModelProto.train_steps")
    ap.add_argument("--batchsize", type=int, default=0,
                    help="override every data layer's batchsize")
    ap.add_argument("--synthetic", action="store_true",
                    help="use a synthetic learnable dataset")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", action="store_true",
                    help="resume training from the workspace's latest "
                         "healthy checkpoint")
    ap.add_argument("--max-restarts", "--max_restarts", type=int,
                    dest="max_restarts", default=3,
                    help="trainer supervision budget (pipeline mode "
                         "is always supervised; default 3)")
    ap.add_argument("--scan_chunk", type=int, default=0)
    ap.add_argument("--health", choices=("on", "off"), default="on",
                    help="numeric-health sentinel on the trainer — "
                         "checkpoint verdicts are what bless a step "
                         "for promotion (docs/FAULT_TOLERANCE.md)")
    ap.add_argument("--health_spec", default=None)
    ap.add_argument("--fault_spec", default=None,
                    help="deterministic fault injection across BOTH "
                         "halves (train + serve sites, plus "
                         "pipeline.publish; singa_tpu_torch/utils/faults.py)")
    ap.add_argument("--serve_spec", default=None,
                    help="ServeSpec for the fleet's engines")
    ap.add_argument("--fleet", type=int, default=2, metavar="N",
                    help="serving fleet size (default 2: one canary, "
                         "one stable)")
    ap.add_argument("--fleet_spec", default=None,
                    help="RouterSpec key=value entries")
    ap.add_argument("--rollout_spec", default=None,
                    help="RolloutSpec key=value entries (poll_s "
                         "bounds the fingerprint-poll half of the "
                         "blessed-to-served lag)")
    ap.add_argument("--pipeline_spec", default=None,
                    help="PipelineSpec key=value entries, e.g. "
                         "'lag_alarm_s=10,join_s=600' "
                         "(singa_tpu_torch/core/pipeline.py)")
    ap.add_argument("--autoscale_spec", default=None,
                    help="enable the SLO-driven autoscaler over the "
                         "pipeline's fleet (AutoScaleSpec key=value "
                         "entries; the blessed-to-served lag joins "
                         "its pressure signals)")
    ap.add_argument("--smoke", type=int, default=0, metavar="N",
                    help="drive >= N in-process client requests while "
                         "training runs, wait for the loop to drain "
                         "(blessed == served), print the pipeline "
                         "snapshot as JSON, and exit (no HTTP)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000,
                    help="FleetServer HTTP port (0 = ephemeral)")
    _add_obs_flags(ap)
    return ap


def pipeline_main(argv, device: DeviceLike = None) -> int:
    """The `pipeline` subcommand: trainer + fleet on `device` (CUDA
    unless the caller passes device='cpu'), one workspace, the
    `PipelineController` owning the seam."""
    args = make_pipeline_argparser().parse_args(argv)
    dev = resolve_device(device)
    from .utils.faults import FaultSchedule, inject
    schedule = (FaultSchedule.parse(args.fault_spec, seed=args.seed)
                if args.fault_spec else None)
    log = obs.get_logger("pipeline")
    obs_on = _obs_enable(args, args.workspace)
    try:
        model = load_model_config(args.model_conf)
        if args.steps is not None:
            model.train_steps = args.steps
        from .data import resolve_data_source
        if args.batchsize:
            for layer in (model.neuralnet.layer
                          if model.neuralnet else []):
                if layer.data_param:
                    layer.data_param.batchsize = args.batchsize
                if layer.seqdata_param:
                    layer.seqdata_param.batchsize = args.batchsize
        input_shapes = discover_input_shapes(
            model, force_synthetic=args.synthetic)

        from .utils.health import HealthMonitor, HealthSpec
        health_spec = HealthSpec.parse(args.health_spec)
        health = (HealthMonitor(health_spec,
                                log_fn=obs.get_logger("health"))
                  if args.health == "on" else None)
        if health is None:
            log("warning: --health off means every checkpoint "
                "publishes unclassified — only the canary gate "
                "stands between a diverged step and traffic")

        trainer = Trainer(model, input_shapes,
                          log_fn=obs.get_logger("trainer"), device=dev,
                          seed=args.seed, health=health)
        reg = obs.registry()
        if reg is not None and health is not None:
            health.register_into(reg)

        from .core.pipeline import PipelineController, PipelineSpec
        from .core.supervisor import Supervisor, TrainingAborted
        sup = Supervisor(trainer, args.workspace,
                         max_restarts=max(args.max_restarts, 1),
                         max_divergences=health_spec.max_divergences,
                         blame_batches=health_spec.blame_batches,
                         lr_backoff=health_spec.lr_backoff,
                         log=obs.get_logger("supervisor"))

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

        def make_train_iter():
            it, _ = resolve_data_source(
                model, bs, seed=args.seed,
                force_synthetic=args.synthetic,
                sample_shapes=input_shapes)
            return it

        from .serve import (AutoScaleSpec, EngineFleet, FleetServer,
                            RolloutSpec, RouterSpec, ServeSpec)
        spec = (ServeSpec.parse(args.serve_spec) if args.serve_spec
                else ServeSpec())
        net = trainer.test_net or trainer.train_net
        # fresh-init fallback: a cold workspace serves the seeded init
        fallback = net.init_params(args.seed, device=dev)
        fleet = EngineFleet.local(
            net, spec, args.fleet, workspace=args.workspace,
            params=fallback, router_spec=RouterSpec.parse(args.fleet_spec),
            rollout_spec=RolloutSpec.parse(args.rollout_spec),
            log_fn=obs.get_logger("fleet"), device=dev)
        ctl = PipelineController(
            sup, fleet, args.workspace,
            spec=PipelineSpec.parse(args.pipeline_spec),
            autoscale_spec=(AutoScaleSpec.parse(args.autoscale_spec)
                            if args.autoscale_spec is not None
                            else None),
            log_fn=log)
        if reg is not None:
            fleet.router.stats.register_into(reg)
            ctl.register_into(reg)

        with inject(schedule):
            if schedule is not None:
                log(f"fault injection active: {args.fault_spec} "
                    f"(seed {args.seed})")
            ctl.start(make_train_iter, seed=args.seed,
                      scan_chunk=args.scan_chunk, resume=args.resume)
            try:
                if args.smoke > 0:
                    rc = _pipeline_smoke(ctl, net, args, log)
                    print(json.dumps(ctl.snapshot()), flush=True)
                    return rc
                front = FleetServer(fleet, host=args.host,
                                    port=args.port, log_fn=log)
                ctl.register_into(front.metrics)
                front.start()
                try:
                    while not ctl.wait(timeout=1.0):
                        pass
                    if isinstance(ctl.train_error, TrainingAborted):
                        log(f"error: {ctl.train_error}")
                    log("pipeline: training finished; fleet keeps "
                        "serving (Ctrl-C to stop)")
                    while True:
                        time.sleep(3600)
                except KeyboardInterrupt:
                    log("pipeline: shutting down")
                    print(json.dumps(ctl.snapshot()), flush=True)
                    return 0
                finally:
                    front.stop()
            finally:
                ctl.stop()
    finally:
        if obs_on:
            obs.disable()


def _pipeline_smoke(ctl, net, args, log) -> int:
    """In-process client loop for `pipeline --smoke N`: keep requests
    flowing while training runs, then wait for the loop to drain
    (every blessed step promoted).  Exit 0 only when training
    finished, no client request failed, and blessed == served."""
    rng = np.random.default_rng(args.seed)
    vocab = _serve_vocab(net)
    sent = failed = 0
    drain_deadline = None
    while True:
        train_done = not ctl.train_running()
        lag = ctl.lag()
        if train_done and drain_deadline is None:
            # bounded drain: give the rollout a few alarm windows to
            # promote the tail, then report whatever lag remains
            drain_deadline = time.monotonic() + \
                3 * float(ctl.spec.lag_alarm_s)
        drained = lag["lag_steps"] == 0
        if train_done and sent >= args.smoke and \
                (drained or ctl.train_error is not None
                 or time.monotonic() >= drain_deadline):
            break
        plen = int(rng.integers(1, 9))
        prompt = rng.integers(0, vocab, plen).astype("int32")
        try:
            out = ctl.generate(prompt)
            sent += 1
            if sent % 25 == 0 or sent == 1:
                log(f"smoke {sent}: step {out['step']} on "
                    f"{out['engine']} (blessed "
                    f"{lag['blessed_step']}, served "
                    f"{lag['served_step']})")
        except Exception as e:  # noqa: BLE001 — a failure is the verdict
            failed += 1
            log(f"warning: smoke request failed "
                f"({type(e).__name__}: {e})")
            time.sleep(0.05)
    lag = ctl.lag()
    ok = (ctl.train_error is None and failed == 0
          and lag["lag_steps"] == 0)
    log(f"pipeline smoke: {sent} requests ({failed} failed), "
        f"blessed {lag['blessed_step']} served {lag['served_step']}"
        + ("" if ctl.train_error is None
           else f", training FAILED: {ctl.train_error!r}"))
    return 0 if ok else 1


def main(argv=None, device: DeviceLike = None) -> int:
    """Training, or the `serve` or `pipeline` subcommand.  `device` is for Python
    callers (tests pass 'cpu'); the command line runs on the card."""
    from .utils.checkpoint import OrbaxUnreadableError
    try:
        return _main(argv, device)
    except OrbaxUnreadableError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


def _main(argv, device: DeviceLike) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "serve":
        return serve_main(argv[1:], device=device)
    if argv and argv[0] == "pipeline":
        return pipeline_main(argv[1:], device=device)
    args = make_argparser().parse_args(argv)
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


def _run(args, device: DeviceLike) -> int:
    log = obs.get_logger("main")
    model = load_model_config(args.model_conf)
    cluster = (load_cluster_config(args.cluster_conf)
               if args.cluster_conf else None)
    ptype = model.neuralnet.partition_type if model.neuralnet else "kNone"
    # the multi-process bootstrap comes before any device is chosen:
    # -procsID/-hostfile are the reference's launch (run.sh:20-37)
    joined = False
    if args.hostfile:
        from .parallel.bootstrap import DEFAULT_PORT, distributed_init
        port = cluster.start_port if cluster else DEFAULT_PORT
        joined = distributed_init(args.procsID, args.hostfile, port=port)
        if joined:
            log(f"process group joined: process {args.procsID}")
    try:
        return _train(args, device, model, cluster, ptype, log)
    finally:
        if joined:
            from .parallel.bootstrap import distributed_shutdown
            distributed_shutdown()


def _train(args, device: DeviceLike, model, cluster, ptype, log) -> int:
    if args.steps is not None:
        model.train_steps = args.steps
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

    # worker-group topology (cluster.h:49-60): nworkers/nprocs_per_group
    # groups; with the async consistency tier active each group is a
    # replica against the shared center (ReplicaSet below)
    ngroups = 1
    if cluster is not None and not cluster.synchronous:
        ngroups = max(cluster.nworkers
                      // max(cluster.nprocs_per_group, 1), 1)

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
    # the mesh over the group's processes, when there are several: its
    # data axis splits every global batch, its model axis the params and
    # its seq axis a sequence-parallel net's tokens (the JAX CLI's mesh
    # over the devices, `:788-797`, and its shard_params after init,
    # `:950-957`, which `Trainer.init` and `resume` do here)
    from .parallel.bootstrap import process_count
    dp = None
    from .parallel.elastic import async_active
    async_multi = ngroups > 1 and async_active(model.updater)
    if process_count() > 1:
        from .parallel.mesh import mesh_from_cluster
        from .parallel.partition import DataParallel
        mesh = mesh_from_cluster(cluster, ptype)
        log(f"mesh: {mesh.shape} over {mesh.size} processes")
        if async_multi:
            log("warning: mesh sharding is not supported on the "
                "multi-group async simulation path; ignoring")
        else:
            dp = DataParallel(mesh)
    trainer = Trainer(model, input_shapes, log_fn=obs.get_logger("trainer"),
                      device=dev, seed=args.seed, health=health,
                      ngroups=ngroups, dp=dp,
                      n_micro=(cluster.pipeline_microbatches
                               if cluster else 0))
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

    if async_multi:
        return _replica_groups(args, model, cluster, trainer, ngroups,
                               workspace, bs, input_shapes, log)

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
            params, _, _ = trainer.run(
                params, opt_state, train_iter,
                test_iter_factory=test_factory, seed=args.seed,
                start_step=start_step, workspace=workspace,
                scan_chunk=args.scan_chunk, feeder=feeder_flag,
                feeder_depth=args.feeder_depth)
        finally:
            train_iter.close()
        if dp is not None:
            from .parallel.comm import stats
            ex = stats(dp.grads)
            log(f"ranks agree: params sha256 "
                f"{dp.agree(params)} (rank {dp.rank} of {dp.n}); "
                f"{ex['calls']} exchanges, {ex['seconds'] * 1e3:.3f} ms in "
                f"all")
            if dp.pipe.n > 1:
                px = stats(dp.pipe, "shift")
                log(f"pipe shifts: {px['calls']} calls, "
                    f"{px['bytes'] / 1e6:.3f} MB sent, "
                    f"{px['seconds'] * 1e3:.3f} ms in all (rank "
                    f"{dp.pipe.index} of the pipe)")
    final = trainer.perf.to_string()
    log("training done" + (f": {final}" if final else
                           f" at step {model.train_steps}"))
    return 0


def _replica_groups(args, model, cluster, trainer, ngroups, workspace, bs,
                    input_shapes, log) -> int:
    """The multi-group async tier (`:852-900`): each group trains its own
    replica and exchanges with the shared center at the UpdaterProto
    cadence; the center is evaluated at the end."""
    from .data import resolve_data_source
    from .parallel.elastic import ReplicaSet
    for flag, what in ((args.resume, "--resume"),
                       (workspace, "checkpointing (workspace)")):
        if flag:
            log(f"warning: {what} is not supported on the multi-group "
                f"async simulation path; ignoring")
    log(f"async replica groups: {ngroups} x {model.updater.param_type}")
    # ClusterProto.bandwidth/nservers drive the runtime SyncConfig
    # (param_manager.cc:85-93): after warmup the RandomSync sample ratio
    # adapts to the configured pipe
    rs = ReplicaSet(trainer, ngroups, seed=args.seed,
                    bandwidth_mb_s=cluster.bandwidth,
                    nservers=cluster.nservers or 1)
    # the same task (seed), a distinct sample stream per replica
    iters = [resolve_data_source(
                 model, bs, seed=args.seed,
                 stream_seed=args.seed + 1000 * (g + 1),
                 force_synthetic=args.synthetic,
                 sample_shapes=input_shapes)[0]
             for g in range(ngroups)]
    try:
        center, history = rs.run(iters, model.train_steps, seed=args.seed)
    finally:
        for it in iters:
            close = getattr(it, "close", None)
            if close is not None:
                close()
    last = history[0][-1] if history and history[0] else {}
    log(f"training done (center of {ngroups} replicas)" +
        (": " + ", ".join(f"{k} : {v:.6f}"
                          for k, v in sorted(last.items()))
         if last else ""))
    test_factory = resolve_data_source(
        model, bs, seed=args.seed, force_synthetic=args.synthetic,
        sample_shapes=input_shapes)[1]
    if trainer.test_step is not None and test_factory is not None \
            and center is not None and model.test_steps > 0:
        it = test_factory()
        try:
            avg = trainer.evaluate(center, it, model.test_steps,
                                   trainer.test_step)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()
        log("center test: " + ", ".join(
            f"{k} : {v:.6f}" for k, v in sorted(avg.items())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
