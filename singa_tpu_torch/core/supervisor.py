"""Supervised training runtime: the failure-recovery loop the reference
designed but never shipped (Worker::Resume, worker.cc:65-67 — an empty
TODO; snapshot restore commented out, blob.cc:300-320).

A `Supervisor` wraps `Trainer` in a resumable state machine:

    INIT ──▶ RESTORE ──▶ TRAIN ──▶ DONE
               ▲            │
               │  backoff   │ failure / preemption
               └────────────┘   (budgeted)

Each attempt: (re)initialize the state triple, restore the latest
*valid* checkpoint (`CheckpointManager.restore` walks back past corrupt
snapshots), fast-forward the data iterator to the restored step, and
run the trainer — which checkpoints on its cadence as usual.  A step or
pipeline failure restores and retries with exponential backoff +
seeded jitter; a simulated/real preemption restarts immediately (a
rescheduled job does not sit out a backoff).  When the retry budget is
exhausted the Supervisor raises a structured `TrainingAborted` carrying
the full failure log.

A third failure kind, `"divergence"` (utils.health.NumericDivergence —
the trainer's health monitor found non-finite or exploding numerics),
has its own budget and its own rescue policy: restore with
`skip_unhealthy=True` so the walk-back lands on the last *numerically
good* snapshot (not merely the last readable one — a snapshot taken in
a spike window carries that verdict in MANIFEST.json), optionally skip
`blame_batches` data batches at the crash step (bad-record blame), and
optionally apply a one-shot learning-rate backoff before retrying.
Like preemptions, divergences retry immediately — waiting does not fix
arithmetic.

Determinism contract (what makes recovery *testable*): the layers that
draw seed their generators from (seed, step, layer) and the data factory
rebuilds the same batch sequence, so restore-at-step-s + replay
reproduces the uninterrupted trajectory exactly.

The port's own copy of `singa_tpu/core/supervisor.py`, on one card: each
attempt calls `trainer.init` and restores into it; a trainer whose steps
are CUDA graphs copies the restored state into the tensors its graphs
were captured over, so a restart captures nothing anew.
"""

from __future__ import annotations

import inspect
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional

from .. import obs
from ..utils.faults import Backoff, Preemption, retry_call
from ..utils.health import NumericDivergence


@dataclass
class FailureRecord:
    """One supervised-run failure, as carried by TrainingAborted and
    `Supervisor.failures`."""
    attempt: int
    kind: str                 # "preemption" | "error" | "divergence"
    error: str                # repr of the exception
    last_step: int            # last step a hook observed before the crash
    restart_step: int         # step the NEXT attempt resumed from
    time: float = field(default_factory=time.time)


class TrainingAborted(RuntimeError):
    """The retry budget is spent; `failures` holds every FailureRecord
    so the operator sees the whole crash history, not just the last
    exception."""

    def __init__(self, message: str, failures: List[FailureRecord]):
        super().__init__(message)
        self.failures = list(failures)

    def __str__(self) -> str:
        lines = [super().__str__()]
        for f in self.failures:
            lines.append(f"  attempt {f.attempt}: {f.kind} after step "
                         f"{f.last_step} — {f.error}")
        return "\n".join(lines)


class Supervisor:
    """Resumable runner around a `Trainer`.

    `max_restarts` budgets *error* restarts (crash loops must stop);
    `max_preemptions` budgets preemption restarts separately and
    defaults to unlimited — preemptions are expected on preemptible
    slices and recovery from them is the point of this class.

    With no `workspace` the Supervisor still retries, but every attempt
    replays from step 0 (nothing was snapshotted) — legal for short
    runs, logged loudly for long ones.
    """

    def __init__(self, trainer, workspace: Optional[str] = None,
                 max_restarts: int = 3,
                 max_preemptions: Optional[int] = None,
                 backoff: Optional[Backoff] = None,
                 restore_retries: int = 3,
                 max_divergences: int = 2,
                 blame_batches: int = 0,
                 lr_backoff: float = 0.0,
                 log: Optional[Callable[[str], None]] = None):
        """`max_divergences`, `blame_batches`, `lr_backoff` configure
        the numeric-divergence rescue policy (docstring above; the
        trainer must carry a HealthMonitor for divergences to be
        raised at all — main.py wires both from `--health_spec`)."""
        self.trainer = trainer
        self.workspace = workspace
        self.max_restarts = max(max_restarts, 0)
        self.max_preemptions = max_preemptions
        self.backoff = backoff or Backoff(base=0.5, cap=30.0, jitter=0.25)
        self.restore_retries = max(restore_retries, 1)
        self.max_divergences = max(max_divergences, 0)
        self.blame_batches = max(blame_batches, 0)
        self.lr_backoff = lr_backoff
        self._blame: set = set()      # global batch indices to skip
        self._skip_unhealthy = False  # armed by the first divergence
        self._lr_backed_off = False   # the backoff is one-shot
        self.log = log or trainer.log
        self.failures: List[FailureRecord] = []
        cfg = trainer.cfg
        if workspace and cfg.checkpoint_frequency <= 0:
            # recovery without a cadence degrades to replay-from-zero;
            # default to ~10 snapshots over the run
            cfg.checkpoint_frequency = max(1, cfg.train_steps // 10)
            self.log(f"supervisor: checkpoint_frequency defaulted to "
                     f"{cfg.checkpoint_frequency} (workspace set, no "
                     f"cadence configured)")
        if not workspace:
            self.log("warning: supervisor has no workspace — failures "
                     "restart training from step 0 (no checkpoints)")

    # -- state machine -----------------------------------------------------
    def _fresh_state(self, seed: int):
        """INIT: the deterministic step-0 state (same seed, same init),
        this rank's shards of it over a model axis (`Trainer.init`
        shards, as the JAX supervisor shards after init)."""
        return self.trainer.init(seed=seed)

    def _restore(self, params, opt, seed: int,
                 corr: Optional[str] = None):
        """RESTORE: latest valid snapshot, with its own (small) retry
        budget — a flaky restore read is not a training failure.  After
        a divergence the restore also skips snapshots with a bad health
        verdict (rollback PAST the unhealthy window).  A snapshot is whole
        and spec-shaped; `Trainer.resume` re-shards it over a model
        axis."""
        if not self.workspace:
            return params, opt, 0
        with obs.span("supervisor.restore", corr=corr,
                      skip_unhealthy=self._skip_unhealthy) as sp:
            out = retry_call(
                lambda: self.trainer.resume(
                    params, opt, self.workspace,
                    skip_unhealthy=self._skip_unhealthy),
                attempts=self.restore_retries,
                backoff=Backoff(base=0.1, cap=5.0, seed=seed),
                log=self.log, what="checkpoint restore")
            sp.set(step=out[2])
        return out

    def _make_iter(self, factory: Callable[..., Iterator],
                   start_step: int) -> Iterator:
        """Fast-forward the train stream to `start_step`.  A factory
        taking a positional arg receives the step (sources that can
        seek do so cheaply); otherwise `start_step` batches are drained
        from a fresh iterator — exact replay either way, because the
        per-step path consumes exactly one batch per step.

        With blamed batches (divergence rescue), the stream is rebuilt
        from index 0, blamed indices are dropped, and the fast-forward
        drains through the FILTERED stream — so the batch offset stays
        exact across any number of later restarts."""
        if self._blame:
            it = self._drop_blamed(factory(), self._blame)
            for _ in range(start_step):
                next(it)
            return it
        if start_step > 0:
            try:
                sig = inspect.signature(factory)
                positional = [
                    p for p in sig.parameters.values()
                    if p.kind in (p.POSITIONAL_ONLY,
                                  p.POSITIONAL_OR_KEYWORD)]
            except (TypeError, ValueError):
                positional = []
            if positional:
                return factory(start_step)
        it = factory()
        for _ in range(start_step):
            next(it)
        return it

    @staticmethod
    def _drop_blamed(it: Iterator, blame) -> Iterator:
        """Yield `it` minus the batches at the blamed stream indices."""
        for i, batch in enumerate(it):
            if i in blame:
                continue
            yield batch

    def run(self, train_iter_factory: Callable[..., Iterator],
            test_iter_factory: Optional[Callable[[], Iterator]] = None,
            val_iter_factory: Optional[Callable[[], Iterator]] = None,
            seed: int = 0, scan_chunk: int = 0,
            hooks: Optional[List[Callable[[int, Dict], None]]] = None,
            resume: bool = False, feeder: Optional[bool] = None,
            feeder_depth: int = 0):
        """Run to train_steps under supervision.  Returns the trainer's
        (params, opt_state, history) — history covers the final
        (successful) attempt.  Raises TrainingAborted when the error
        budget is spent.

        `feeder`/`feeder_depth` pass through to Trainer.run's overlapped
        feed pipeline; recovery is feeder-transparent — each attempt
        rebuilds the fast-forwarded iterator and a FRESH DeviceFeeder
        whose chunk plan starts at the restored step, and failures on
        the staging thread (the `feed.stage` site) surface on the
        consumer side like any step failure."""
        errors = preemptions = divergences = 0
        attempt = 0
        last_seen = [-1]
        probes = [lambda s, m: last_seen.__setitem__(0, s)]
        if hooks:
            probes += list(hooks)
        while True:
            attempt += 1
            corr = f"attempt-{attempt}"
            monitor = getattr(self.trainer, "health", None)
            if monitor is not None:
                # rolling statistics from a poisoned attempt must not
                # leak into the retry's classification
                monitor.reset()
            params, opt = self._fresh_state(seed)
            start_step = 0
            if self.workspace and (resume or attempt > 1):
                params, opt, start_step = self._restore(params, opt,
                                                        seed, corr=corr)
                if start_step > 0:
                    self.log(f"supervisor: resumed from step "
                             f"{start_step} (attempt {attempt})")
                    obs.emit_event("supervisor.resumed",
                                   corr=corr, attempt=attempt,
                                   step=start_step)
                elif attempt > 1:
                    self.log("supervisor: no valid checkpoint; "
                             "replaying from step 0")
            it = None
            try:
                # inside the try: a data-source failure during rebuild
                # or fast-forward is retried like any step failure.
                # The attempt span carries the recovery correlation id:
                # trainer chunk / drain / checkpoint spans open inside
                # it (same thread) and inherit `attempt-N`.
                with obs.span("supervisor.attempt", corr=corr,
                              attempt=attempt, start_step=start_step):
                    it = self._make_iter(train_iter_factory, start_step)
                    return self.trainer.run(
                        params, opt, it,
                        test_iter_factory=test_iter_factory,
                        val_iter_factory=val_iter_factory,
                        start_step=start_step, seed=seed, hooks=probes,
                        workspace=self.workspace, scan_chunk=scan_chunk,
                        feeder=feeder, feeder_depth=feeder_depth)
            except Preemption as e:
                preemptions += 1
                self._record(attempt, "preemption", e, last_seen[0])
                if (self.max_preemptions is not None
                        and preemptions > self.max_preemptions):
                    raise self._abort(
                        f"{preemptions} preemptions exceed the budget "
                        f"of {self.max_preemptions}") from e
                self.log(f"supervisor: preemption at ~step "
                         f"{last_seen[0]} ({e}); restarting "
                         f"immediately")
            except NumericDivergence as e:
                divergences += 1
                self._record(attempt, "divergence", e, last_seen[0])
                if divergences > self.max_divergences:
                    raise self._abort(
                        f"{divergences} numeric divergences exceed the "
                        f"budget of {self.max_divergences}") from e
                self._rescue(e)
            except Exception as e:  # noqa: BLE001 — any runtime failure
                errors += 1
                self._record(attempt, "error", e, last_seen[0])
                if errors > self.max_restarts:
                    raise self._abort(
                        f"{errors} failures exceed the restart budget "
                        f"of {self.max_restarts}") from e
                delay = self.backoff.delay(errors - 1)
                self.log(f"supervisor: failure at ~step {last_seen[0]} "
                         f"({type(e).__name__}: {e}); retrying in "
                         f"{delay:.2f}s (error {errors}/"
                         f"{self.max_restarts} of budget)")
                time.sleep(delay)
            finally:
                close = getattr(it, "close", None) if it is not None \
                    else None
                if close is not None:
                    try:
                        close()
                    except Exception:  # pragma: no cover
                        pass

    def _rescue(self, e: NumericDivergence) -> None:
        """Divergence rescue policy: arm skip-unhealthy restores, blame
        the batches at the crash step, and (once) back off the learning
        rate.  Retries immediately — backoff sleeps don't fix NaNs."""
        with obs.span("supervisor.rescue", step=e.step):
            self._skip_unhealthy = True
            actions = ["rolling back past the unhealthy window"]
            if self.blame_batches > 0:
                first = max(e.step, 0)
                blamed = range(first, first + self.blame_batches)
                self._blame.update(blamed)
                actions.append(f"blaming batches "
                               f"[{first}, {first + self.blame_batches})")
            if self.lr_backoff and not self._lr_backed_off:
                scale = self.trainer.apply_lr_backoff(self.lr_backoff)
                self._lr_backed_off = True
                actions.append(f"LR backoff x{self.lr_backoff:g} "
                               f"(scale now {scale:g})")
            self.log(f"supervisor: numeric divergence at step {e.step} "
                     f"({e}); {'; '.join(actions)}; retrying immediately")
            obs.emit_event("supervisor.rescue", step=e.step,
                           actions=actions, error=repr(e))

    def _record(self, attempt: int, kind: str, exc: BaseException,
                last_step: int) -> None:
        restart = 0
        if self.workspace:
            try:
                from ..utils.checkpoint import CheckpointManager
                restart = CheckpointManager(
                    self.workspace, log_fn=self.log).latest_step() or 0
            except Exception:  # pragma: no cover — diagnostics only
                restart = -1
        self.failures.append(FailureRecord(
            attempt=attempt, kind=kind, error=repr(exc),
            last_step=last_step, restart_step=restart))
        obs.emit_event("supervisor.restart", corr=f"attempt-{attempt}",
                       attempt=attempt, fail_kind=kind,
                       error=repr(exc), last_step=last_step,
                       restart_step=restart)

    def _abort(self, why: str) -> TrainingAborted:
        obs.emit_event("supervisor.abort", why=why,
                       failures=len(self.failures))
        return TrainingAborted(f"training aborted: {why}", self.failures)
