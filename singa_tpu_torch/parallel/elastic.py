"""Asynchronous multi-replica consistency tier on one card: Elastic
averaging (EASGD) and RandomSync, the reference parameter server's two
sync algorithms.

Port of the in-process part of `singa_tpu/parallel/elastic.py`
(`:39-430`).  Reference semantics:
- **Elastic** (EASGD, param.cc:216-256): each replica periodically
  exchanges with a center copy: diff = (replica - center) * alpha;
  center += diff; replica -= diff; alpha = moving_rate / ngroups
  (param_manager.cc:15).  Cadence: UpdaterProto.sync_frequency after
  warmup_steps (model.proto:336-338, worker.cc:44-55).
- **RandomSync** (param.cc:102-213): the replica sends a seeded random
  sample of (data - snapshot) deltas; the center adds them, the replica
  overwrites the sampled entries with the center's values and updates
  its snapshot.  The sample size follows the bandwidth model
  (param_manager.cc:85-93).

The exchanges work IN PLACE on dicts of tensors (`torch._foreach_*`
passes, the JAX package's arithmetic op for op): a trainer's CUDA
graphs own their params, so a sync must land in those very tensors (a
new dict would be copied in silently at the next replay).  RandomSync
is split in two: `randomsync_masks` draws the masks from an explicit
`torch.Generator` (seeded from (seed, step, group) as the JAX
controller's `_fallback_rng` folds its key), `randomsync_apply` applies
given masks, so a test can feed it the masks JAX draws.

`DistributedReplicaSet` (`:432-734`) runs the same tier over real
transport: one replica per process of a `torch.distributed` group
(`parallel/bootstrap.py`), the replicas all-gathered over gloo (staged
through the host), and every process applying the same sequential
center chain as `ReplicaSet`, so no coordinator can fail.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Optional

import torch

from ..config.schema import UpdaterConfig
from ..core.layers import fold_in
from ..utils.faults import Backoff, Preemption, maybe_fault
from ..utils.health import SPIKE_SCALE, delta_health

Tree = Dict[str, torch.Tensor]


class SyncRoundSkipped(RuntimeError):
    """Internal signal: a center exchange failed past its retry budget;
    the caller degrades to 'skip this sync round'."""


def _lists(*trees: Tree):
    """The tensors of each tree in one key order (the first tree's,
    sorted, as JAX flattens a dict)."""
    keys = sorted(trees[0])
    return [[t[k] for k in keys] for t in trees]


def _poisoned_contrib(params: Tree, kind) -> Tree:
    """Honor a silent `sync.delta` fault: the replica's contribution is
    a poisoned copy (NaN / scaled) BEFORE validation sees it — the
    stand-in for a diverged replica or a corrupted transfer."""
    if kind not in ("nan", "spike"):
        return params
    scale = float("nan") if kind == "nan" else SPIKE_SCALE
    keys = sorted(params)
    return dict(zip(keys, torch._foreach_mul([params[k] for k in keys],
                                             scale)))


def sync_with_retries(exchange, *, attempts: int = 3,
                      backoff: Optional[Backoff] = None,
                      log=print, step: Optional[int] = None):
    """Run `exchange()` with retries and exponential backoff; the
    `sync.elastic` fault site fires before each attempt.  A failed
    exchange degrades to SKIPPING the round (the async algorithms
    tolerate a missed round by construction): returns exchange()'s
    value, or raises SyncRoundSkipped after the budget.  Preemption
    always propagates."""
    backoff = backoff or Backoff(base=0.05, cap=2.0, seed=step or 0)
    last: Optional[BaseException] = None
    for k in range(max(attempts, 1)):
        try:
            maybe_fault("sync.elastic")
            return exchange()
        except Preemption:
            raise
        except Exception as e:  # noqa: BLE001 — transport/runtime faults
            last = e
            log(f"warning: cross-slice sync failed"
                + (f" at step {step}" if step is not None else "")
                + f" (attempt {k + 1}/{attempts}): {e}")
            if k + 1 < attempts:
                backoff.sleep(k)
    raise SyncRoundSkipped(
        f"cross-slice sync abandoned after {attempts} attempts: {last}"
    ) from last


@torch.no_grad()
def elastic_update(replica: Tree, center: Tree, alpha: float):
    """One EASGD exchange (param.cc:232-256), in place on both trees.
    Returns (replica, center)."""
    r, c = _lists(replica, center)
    diff = torch._foreach_sub(r, c)
    torch._foreach_mul_(diff, alpha)
    torch._foreach_sub_(r, diff)
    torch._foreach_add_(c, diff)
    return replica, center


def mask_generator(seed: int, device) -> torch.Generator:
    """A generator for `randomsync_masks` on `device`, seeded with
    `seed` (a 64-bit fold, `ElasticController._fallback_rng`)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & ((1 << 63) - 1))
    return gen


@torch.no_grad()
def randomsync_masks(replica: Tree, sample_ratio: float,
                     generator: torch.Generator) -> Tree:
    """A uniform draw per entry, in sorted key order: 1 where it falls
    below `sample_ratio`, else 0, in the replica's dtype."""
    return {k: (torch.rand(replica[k].shape, generator=generator,
                           device=replica[k].device) < sample_ratio
                ).to(replica[k].dtype)
            for k in sorted(replica)}


@torch.no_grad()
def randomsync_apply(replica: Tree, center: Tree, snapshot: Tree,
                     masks: Tree):
    """One RandomSync exchange (param.cc:102-213) with given masks, in
    place: the center absorbs the replica's masked delta against its
    snapshot, and the replica and snapshot adopt the center's resulting
    values at the mask.  Returns (replica, center, snapshot)."""
    r, c, s, m = _lists(replica, center, snapshot, masks)
    delta = torch._foreach_sub(r, s)
    torch._foreach_mul_(delta, m)
    torch._foreach_add_(c, delta)                 # c2 = c + delta
    keep = torch._foreach_neg(m)
    torch._foreach_add_(keep, 1.0)                # 1 - mask
    cm = torch._foreach_mul(c, m)                 # c2 * mask
    for x in (r, s):
        torch._foreach_mul_(x, keep)
        torch._foreach_add_(x, cm)
    return replica, center, snapshot


def randomsync_update(replica: Tree, center: Tree, snapshot: Tree,
                      sample_ratio: float, generator: torch.Generator):
    """Draw the masks, then apply them: the JAX `randomsync_update`."""
    return randomsync_apply(replica, center, snapshot,
                            randomsync_masks(replica, sample_ratio,
                                             generator))


def sync_sample_ratio(bandwidth_mb_s: float, nservers: int, nworkers: int,
                      model_size_floats: int, compute_time_s: float) -> float:
    """Bandwidth-adaptive sample ratio (param_manager.cc:85-93): the
    fraction of the model that fits through the pipe per step."""
    if model_size_floats <= 0 or compute_time_s <= 0:
        return 1.0
    # MB means 1024*1024 here, matching the reference formula's units
    throughput = bandwidth_mb_s * 1024 * 1024 / 4.0 * nservers  # floats/sec
    demand = model_size_floats * nworkers / compute_time_s
    return float(max(0.0, min(1.0, throughput / demand)))


def sync_now(cfg: UpdaterConfig, step: int) -> bool:
    """warmup_steps then every sync_frequency (worker.cc:44-55) — the
    one cadence predicate of the controller, the trainer's chunk cuts
    and the round-robin replicas."""
    return (step >= cfg.warmup_steps
            and cfg.sync_frequency > 0
            and (step - cfg.warmup_steps) % cfg.sync_frequency == 0)


def easgd_alpha(cfg: UpdaterConfig, ngroups: int) -> float:
    """alpha = moving_rate / ngroups (param_manager.cc:15)."""
    return cfg.moving_rate / max(ngroups, 1) if cfg.moving_rate else 0.0


def async_active(ucfg: Optional[UpdaterConfig]) -> bool:
    """True when UpdaterProto's consistency knobs request the async
    tier: RandomSync explicitly, or Elastic with a nonzero moving_rate
    (mlp.conf sets moving_rate 0.9, sync_frequency 8; moving_rate's
    default 0 keeps plain-sync configs inert)."""
    return (ucfg is not None and ucfg.sync_frequency > 0
            and (ucfg.param_type == "RandomSync"
                 or (ucfg.param_type == "Elastic"
                     and ucfg.moving_rate > 0)))


def _copy(tree: Tree) -> Tree:
    keys = sorted(tree)
    return dict(zip(keys, torch._foreach_mul([tree[k] for k in keys], 1.0)))


class ElasticController:
    """The consistency driver with the reference's cadence knobs: one
    per replica, `maybe_sync(step, params)` called after each step
    with that replica's params (updated in place)."""

    def __init__(self, cfg: UpdaterConfig, ngroups: int = 1,
                 bandwidth_mb_s: float = 0.0, nservers: int = 1,
                 log_fn=print, sync_retries: int = 3,
                 sync_backoff: Optional[Backoff] = None,
                 validate: bool = True, delta_max_norm: float = 0.0,
                 seed: int = 0, group: int = 0):
        """`validate` rejects a non-finite (or, with `delta_max_norm`,
        norm-exploded) replica contribution before it touches the
        center — the poisoned round degrades to a skipped one (counted
        in `poisoned_rounds`), exactly like a failed transport round.
        `seed`/`group` seed the RandomSync masks of a `maybe_sync`
        called without `rng`."""
        self.cfg = cfg
        self.alpha = easgd_alpha(cfg, ngroups)
        self.mode = cfg.param_type           # "Elastic" | "RandomSync"
        self.center: Optional[Tree] = None
        self.snapshot: Optional[Tree] = None
        self.sample_ratio = 1.0
        self.bandwidth_mb_s = bandwidth_mb_s
        self.nservers = max(nservers, 1)
        self.log = log_fn
        self.sync_retries = max(sync_retries, 1)
        self.sync_backoff = sync_backoff
        self.skipped_rounds = 0
        self.validate = validate
        self.delta_max_norm = delta_max_norm
        self.poisoned_rounds = 0
        self.seed = seed
        self.group = group

    def configure_sync(self, compute_time_s: float,
                       model_size_floats: int, nworkers: int) -> None:
        """Runtime SyncConfig (param_manager.cc:85-93, called with the
        measured warmup step time, worker.cc:42-48): adapt the
        RandomSync sample ratio to the configured pipe.  A zero
        bandwidth leaves sampling at 1.0."""
        if self.bandwidth_mb_s > 0:
            self.sample_ratio = sync_sample_ratio(
                self.bandwidth_mb_s, self.nservers, nworkers,
                model_size_floats, compute_time_s)

    def init(self, params: Tree) -> None:
        self.center = _copy(params)
        if self.mode == "RandomSync":
            self.snapshot = _copy(params)

    def sync_now(self, step: int) -> bool:
        return sync_now(self.cfg, step)

    def _fallback_rng(self, step: int) -> int:
        """The masks' seed at `step`: (seed, step, group) folded as the
        JAX controller folds its key, `fold_in(fold_in(PRNGKey(seed ^
        0xA57), step), group)` (other numbers, the same structure)."""
        return fold_in(self.seed ^ 0xA57, step, self.group)

    def maybe_sync(self, step: int, params: Tree,
                   rng: Optional[int] = None) -> Tree:
        """Exchange with the center at the cadence; `params` are updated
        in place and returned.  The center initializes lazily from the
        FIRST post-warmup params (the reference worker pushes its
        trained params after the warmup loop, worker.cc:50-55).

        `rng` seeds RandomSync's masks (an int; by default folded from
        the controller's seed, the step and its group).  With `validate`
        a poisoned contribution never touches the center: the round is
        rejected, `poisoned_rounds` counts it, and the replica keeps its
        own params."""
        if not self.sync_now(step):
            return params
        if self.center is None:
            if self.validate:
                ok, _ = delta_health(params)
                if not ok:
                    # a non-finite replica must not SEED the center
                    self.poisoned_rounds += 1
                    self.log(f"warning: poisoned params at center init "
                             f"(step {step}): non-finite; round "
                             f"skipped, center not seeded")
                    return params
            self.init(params)
            return params
        contrib = _poisoned_contrib(params, maybe_fault("sync.delta"))
        if self.mode == "RandomSync":
            if self.snapshot is None:
                # a replica joining an existing center: its first delta
                # baseline is its own current params
                self.snapshot = _copy(params)
            ref = self.snapshot
            gen = mask_generator(
                rng if rng is not None else self._fallback_rng(step),
                next(iter(params.values())).device)

            def exchange():
                randomsync_update(contrib, self.center, self.snapshot,
                                  self.sample_ratio, gen)
        else:
            ref = self.center

            def exchange():
                elastic_update(contrib, self.center, self.alpha)
        if self.validate:
            ok, norm = delta_health(contrib, ref,
                                    max_norm=self.delta_max_norm)
            if not ok:
                self.poisoned_rounds += 1
                self.log(f"warning: poisoned sync delta at step {step} "
                         f"(delta norm {norm:.6g}"
                         + (f" > cap {self.delta_max_norm:.6g}"
                            if math.isfinite(norm) else ": non-finite")
                         + "); rejecting exchange — center untouched")
                return params
        try:
            sync_with_retries(exchange, attempts=self.sync_retries,
                              backoff=self.sync_backoff,
                              log=self.log, step=step)
        except SyncRoundSkipped as e:
            # the replica keeps training on its own params; the next
            # cadence step exchanges a (larger) delta as usual
            self.skipped_rounds += 1
            self.log(f"warning: skipping sync round at step {step} "
                     f"({e}); replica continues un-synced")
            return params
        if contrib is not params:
            # the exchange ran on a poisoned copy: its result is the
            # replica's, as the JAX controller returns it
            with torch.no_grad():
                for p, c in zip(*_lists(params, contrib)):
                    p.copy_(c)
        return params


class ReplicaSet:
    """The reference's worker-group topology on one card: `ngroups`
    replicas train round-robin against one shared center copy (the
    parameter server's role, param.cc:102-256).

    Each replica owns its params and optimizer state (its own storage:
    under CUDA graphs the trainer's graphs own another set, which a
    step copies the replica into and out of, so replicas never alias
    each other or the graphs) and its data stream, and exchanges with
    the shared center at the UpdaterProto cadence.  RandomSync snapshots
    are per replica (param.cc:102-213).  The center seeds lazily from
    the first replica to finish warmup (worker.cc:50-55)."""

    def __init__(self, trainer, ngroups: int, seed: int = 0,
                 bandwidth_mb_s: float = 0.0, nservers: int = 1,
                 quarantine_after: int = 3):
        """`quarantine_after`: consecutive poisoned sync rounds after
        which a replica is QUARANTINED — pulled out of the round-robin
        instead of dragging the center round after round."""
        self.trainer = trainer
        self.ngroups = ngroups
        self.seed = seed
        self.quarantine_after = max(quarantine_after, 1)
        cfg = trainer.cfg.updater
        self.controllers = [ElasticController(
            cfg, ngroups, bandwidth_mb_s=bandwidth_mb_s,
            nservers=nservers, log_fn=trainer.log,
            seed=seed, group=g) for g in range(ngroups)]
        if trainer.graphs and not trainer._state:
            # the graphs adopt the first tensors a step is given: hand
            # them a set of their own, so no replica's becomes theirs
            from ..core.trainer import _own
            _own(trainer._state, *trainer.init(seed=seed))
        self.replicas = []
        for _ in range(ngroups):
            # every replica starts from the SAME initialization (the
            # reference's group 0 initializes, the others fetch it,
            # worker.cc Setup); divergence comes from the data streams
            p, o = trainer.init(seed=seed)
            self.replicas.append({"params": p, "opt": o,
                                  "quarantined": False, "strikes": 0})

    def _share_center(self, src: ElasticController) -> None:
        # one center: the exchanges update it in place, so every
        # controller holds the same tensors.  Snapshots stay per replica.
        for c in self.controllers:
            c.center = src.center

    def _step(self, g: int, rep, batch, step: int):
        """One train step of replica `g` on its own storage; returns the
        step's metrics as floats (a replay's are overwritten by the
        next)."""
        from ..core.trainer import _copy_into
        tr = self.trainer
        seed = tr.seed
        # each replica draws its own stream, as the JAX set folds the
        # group into the step's key
        tr.seed = fold_in(self.seed ^ 0xA57, g)
        try:
            p, o, metrics = tr.train_step(rep["params"], rep["opt"], batch,
                                          step)
        finally:
            tr.seed = seed
        if p is not rep["params"]:
            with torch.no_grad():
                _copy_into(rep["params"], p, "params")
                _copy_into(rep["opt"], o, "opt")
        return {k: float(v) for k, v in metrics.items()}

    def run(self, data_iters, steps: int, seed: int = 0,
            hooks: Optional[list] = None):
        """Train every replica for `steps` steps, one step per replica
        per round (replicas hit the center at interleaved times).
        Returns the final center params and per-replica metric
        history."""
        if len(data_iters) != self.ngroups:
            raise ValueError(f"need {self.ngroups} data iterators, got "
                             f"{len(data_iters)}")
        self.seed = seed
        history = [[] for _ in range(self.ngroups)]
        warmup = self.trainer.cfg.updater.warmup_steps
        t_warm = None
        for step in range(steps):
            # warmup timing for the bandwidth model (worker.cc:42-48
            # times the warmup loop, then SyncConfig); step 0 pays the
            # capture and is left out
            if step == 1 and warmup > 1:
                t_warm = time.perf_counter()
            if step == warmup and t_warm is not None:
                per_step = ((time.perf_counter() - t_warm)
                            / ((warmup - 1) * self.ngroups))
                size = sum(v.numel() for v in
                           self.replicas[0]["params"].values())
                for c in self.controllers:
                    c.configure_sync(per_step, size, self.ngroups)
            for g, rep in enumerate(self.replicas):
                if rep["quarantined"]:
                    continue
                metrics = self._step(g, rep, next(data_iters[g]), step)
                ctl = self.controllers[g]
                poisoned_before = ctl.poisoned_rounds
                ctl.maybe_sync(step, rep["params"])
                if ctl.poisoned_rounds > poisoned_before:
                    # this replica's delta was rejected; repeated
                    # offenders leave the rotation
                    rep["strikes"] += 1
                    if rep["strikes"] >= self.quarantine_after:
                        rep["quarantined"] = True
                        self.trainer.log(
                            f"warning: quarantining replica {g} at "
                            f"step {step} after {rep['strikes']} "
                            f"consecutive poisoned sync rounds — it no "
                            f"longer trains or exchanges")
                        continue
                elif ctl.sync_now(step):
                    # a completed clean round clears the streak
                    rep["strikes"] = 0
                if ctl.center is not None:
                    self._share_center(ctl)
                history[g].append(metrics)
                for h in hooks or ():
                    h(step, g, metrics)
        return self.controllers[0].center, history

    @property
    def center(self) -> Optional[Tree]:
        return self.controllers[0].center


class DistributedReplicaSet:
    """The async consistency tier over real transport: one replica per
    process of the group, the role the reference's ZMQ worker<->server
    delta push/pull played (param_manager.cc:100-153,
    server.cc:45-214).

    Trajectory-exact with `ReplicaSet` on the same seeds: an exchange
    all-gathers every replica (and, for RandomSync, its snapshot) over
    the group, staged through the host, and every process applies the
    same sequential center chain `ReplicaSet` applies (replica 0 first,
    then 1, ...), with the same lazy center init (the first post-warmup
    sync seeds the center from replica 0, which skips its own exchange
    that step, and the others exchange against it with zero-delta
    snapshots), the same per-replica RandomSync snapshots and the same
    masks (`mask_generator` seeded from (seed, step, replica)).  Every
    process holds the same center, so no coordinator can fail.

    An exchange commits all at once: the chain runs on copies, and the
    params (in place: a trainer's graphs own them), the snapshot and the
    center change only after it finished, so a failure mid-exchange
    leaves all three as they were.  With `validate`, a round in which
    any replica's contribution is non-finite (or, with
    `delta_max_norm`, further from the center than that) is rejected on
    every process alike (`poisoned_rounds`); a failed exchange is
    retried and then skipped (`sync_with_retries`, `skipped_rounds`)."""

    def __init__(self, trainer, seed: int = 0,
                 bandwidth_mb_s: float = 0.0, nservers: int = 1,
                 validate: bool = True, delta_max_norm: float = 0.0):
        from .bootstrap import process_count, process_index
        self.trainer = trainer
        self.proc = process_index()
        self.ngroups = process_count()
        cfg = trainer.cfg.updater
        self.cfg = cfg
        self.alpha = easgd_alpha(cfg, self.ngroups)
        self.mode = cfg.param_type
        self.seed = seed
        self.center: Optional[Tree] = None
        self.snapshot: Optional[Tree] = None
        self.sample_ratio = 1.0
        self.bandwidth_mb_s = bandwidth_mb_s
        self.nservers = max(nservers, 1)
        self.params, self.opt = trainer.init(seed=seed)
        self.sync_retries = 3
        self.skipped_rounds = 0
        self.validate = validate
        self.delta_max_norm = delta_max_norm
        self.poisoned_rounds = 0
        # seconds in the all-gather (host staging included), and calls
        self.gather_seconds = 0.0
        self.gathers = 0

    def _sync_now(self, step: int) -> bool:
        return sync_now(self.cfg, step)

    def _gather(self, trees):
        """Every process's `trees` (flat dicts of this process's tensors,
        all with the first one's keys and shapes), as a list over the
        processes in rank order, on this process's device: one host
        all-gather of one packed f32 buffer."""
        import torch.distributed as dist
        t0 = time.perf_counter()
        keys = sorted(trees[0])
        flat = torch.cat([t[k].detach().reshape(-1).float()
                          for t in trees for k in keys]).cpu()
        if self.ngroups > 1:
            parts = [torch.empty_like(flat) for _ in range(self.ngroups)]
            dist.all_gather(parts, flat)
        else:
            parts = [flat]
        dev = trees[0][keys[0]].device
        out = []
        for part in parts:
            d = part.to(dev)
            off, got = 0, []
            for t in trees:
                tree = {}
                for k in keys:
                    n = t[k].numel()
                    tree[k] = d[off:off + n].view(t[k].shape).to(t[k].dtype)
                    off += n
                got.append(tree)
            out.append(got)
        self.gather_seconds += time.perf_counter() - t0
        self.gathers += 1
        return out

    def _exchange(self, rs, center, ss, step: int, init: bool):
        """The sequential center chain over the gathered replicas `rs`
        (and snapshots `ss`, RandomSync), on tensors of this call's own:
        returns (replicas, center, snapshots)."""
        if init:
            center = _copy(rs[0])
            if self.mode == "RandomSync":
                ss = [_copy(r) for r in rs]
        else:
            center = _copy(center)
        for g in range(1 if init else 0, self.ngroups):
            if self.mode == "RandomSync":
                gen = mask_generator(fold_in(self.seed ^ 0xA57, step, g),
                                     next(iter(rs[g].values())).device)
                randomsync_update(rs[g], center, ss[g], self.sample_ratio,
                                  gen)
            else:
                elastic_update(rs[g], center, self.alpha)
        return rs, center, ss

    def _sync(self, step: int) -> bool:
        """One center exchange.  Returns False when the round was
        rejected by delta validation (a poisoned contribution: counted,
        nothing changed), True otherwise."""
        init = self.center is None
        contrib = _poisoned_contrib(self.params, maybe_fault("sync.delta"))
        local = [contrib]
        if self.mode == "RandomSync":
            local.append(self.snapshot if self.snapshot is not None
                         else self.params)
        gathered = self._gather(local)
        rs = [g[0] for g in gathered]
        ss = [g[1] for g in gathered] if self.mode == "RandomSync" else None
        if self.validate:
            # on the init round a "delta" is the raw params: only the
            # finiteness leg applies there
            checks = [delta_health(r, None if init else self.center,
                                   max_norm=0.0 if init
                                   else self.delta_max_norm) for r in rs]
            bad = [g for g, (ok, _) in enumerate(checks) if not ok]
            if bad:
                self.poisoned_rounds += 1
                self.trainer.log(
                    f"warning: poisoned sync delta at step {step} from "
                    f"replica(s) {bad} (delta norms "
                    f"{[checks[g][1] for g in bad]}); rejecting exchange "
                    f"— center untouched")
                return False
        rs, center, ss = self._exchange(rs, self.center, ss, step, init)
        # -- the commit: nothing above changed this process's state --
        with torch.no_grad():
            for k, v in rs[self.proc].items():
                self.params[k].copy_(v)
        if self.mode == "RandomSync":
            self.snapshot = ss[self.proc]
        self.center = center
        return True

    def run(self, data_iter, steps: int, seed: int = 0,
            hooks: Optional[list] = None):
        """Train this process's replica for `steps` steps with center
        exchanges at the UpdaterProto cadence.  Returns (center,
        history), history being this replica's metrics."""
        tr = self.trainer
        g = self.proc
        history = []
        warmup = self.cfg.warmup_steps
        t_warm = None
        saved_seed = tr.seed
        # this replica's draws, as `ReplicaSet` folds the group in
        tr.seed = fold_in(seed ^ 0xA57, g)
        try:
            for step in range(steps):
                # warmup timing for the bandwidth model; every process
                # must agree on one ratio, so the per-process times are
                # averaged over the group
                if step == 1 and warmup > 1:
                    t_warm = time.perf_counter()
                if (step == warmup and t_warm is not None
                        and self.bandwidth_mb_s > 0):
                    per_step = (time.perf_counter() - t_warm) / (warmup - 1)
                    t = torch.tensor([per_step], dtype=torch.float64)
                    per_step = float(torch.stack(
                        [x[0]["t"] for x in self._gather([{"t": t}])]
                    ).mean())
                    size = sum(v.numel() for v in self.params.values())
                    self.sample_ratio = sync_sample_ratio(
                        self.bandwidth_mb_s, self.nservers, self.ngroups,
                        size, per_step)
                self.params, self.opt, m = tr.train_step(
                    self.params, self.opt, next(data_iter), step)
                metrics = {k: float(v) for k, v in m.items()}
                if self._sync_now(step):
                    # every process makes the same skip/retry decision (a
                    # failed collective raises on all of them, and the
                    # seeded backoff keys on `step`), or the next
                    # exchange would deadlock
                    try:
                        sync_with_retries(lambda: self._sync(step),
                                          attempts=self.sync_retries,
                                          log=tr.log, step=step)
                    except SyncRoundSkipped as e:
                        self.skipped_rounds += 1
                        tr.log(f"warning: skipping sync round at step "
                               f"{step} ({e}); replica continues un-synced")
                history.append(metrics)
                for h in hooks or ():
                    h(step, g, metrics)
        finally:
            tr.seed = saved_seed
        return self.center, history
