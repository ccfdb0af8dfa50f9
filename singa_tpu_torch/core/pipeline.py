"""Closed-loop train-and-serve pipeline on one card: one workspace, a
supervised trainer publishing into it, and a serving fleet promoting out
of it.  The port's copy of `singa_tpu/core/pipeline.py` (host code; the
same spec grammar, snapshot keys, Prometheus names, events and the
`pipeline.publish` fault site).

`PipelineController` owns both halves and the seam between them:

    trainer ──save──▶ workspace ──fingerprint──▶ rollout ──▶ traffic
       ▲                 │                          │
       └── Supervisor    └── MANIFEST.json          └── canary →
           restart/rescue    health verdicts            promote/rollback

Publication state machine (one checkpoint's life):

    SAVED      Trainer._save_checkpoint wrote the snapshot + verdict
               (drain-before-save ⇒ drain-before-publish: every step
               the snapshot contains was classified first; a fatal
               window is REFUSED and never reaches disk)
    PUBLISHED  the `on_checkpoint` hook fired (`pipeline.publish`
               span/event, `pipeline.publish` fault site).  A verdict
               of ok/None makes the step BLESSED; a suspect (spike)
               save is published but NOT blessed — the rollout's
               manifest gate will reject it at the canary
    CANARIED   the fleet's RolloutController noticed the fingerprint
               change on its own poll (the publish hook is telemetry,
               not a command channel — losing it loses nothing) and
               reloaded exactly ONE engine
    PROMOTED / the canary verdict decides; ROLLBACK restores the
    ROLLED-BACK  canary to the pinned step (or to fresh-init params
               when nothing was ever promoted — `reload(step=-1)`)

The checkpoint-to-traffic lag gauge is the loop's health number:
`lag_steps` = last blessed step − fleet pinned (served) step, and
`lag_s` = seconds the oldest not-yet-served blessed step has been
waiting.  Both are 0 in steady state; a lag that only grows means the
loop is open (rollout dead, every canary rejected, or the fleet
wedged) — `spec.lag_alarm_s` logs it loudly.

On the card the trainer thread captures and replays its step graphs
while the engines' threads replay theirs and the rollout thread copies
reloads into the served params; captures are thread-local, and every
engine captured at its warm-up, before training starts.

Safety invariants (tests/test_torch_pipeline.py; `chip_smoke.py` phase
16 on the card):
  * a DIVERGED/NONFINITE window never reaches disk (save refused), a
    suspect one never passes the canary gate — so a bad step is never
    served by more than the canary, and traffic never regresses below
    the pinned step;
  * the trainer and the serving poll race safely: a mid-rename or
    half-written MANIFEST.json reads as "no change", never an exception
    or a torn reload;
  * a trainer crash/preemption mid-pipeline is the Supervisor's
    problem and invisible to traffic — the fleet keeps serving the
    pinned step, and the restarted trainer's next blessed save
    re-enters the loop.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from .. import obs
from ..utils import faults


@dataclass(frozen=True)
class PipelineSpec:
    """`--pipeline_spec` grammar (RolloutSpec mold): comma/semicolon-
    separated `key=value`."""
    lag_alarm_s: float = 10.0   # blessed→served lag that logs an alarm
    join_s: float = 600.0       # default wait() budget for training
    seed: int = 0

    def __post_init__(self):
        if float(self.lag_alarm_s) <= 0:
            raise ValueError(f"lag_alarm_s must be > 0, got "
                             f"{self.lag_alarm_s}")
        if float(self.join_s) <= 0:
            raise ValueError(f"join_s must be > 0, got {self.join_s}")

    @classmethod
    def parse(cls, spec: Optional[str]) -> "PipelineSpec":
        kw: Dict[str, Any] = {}
        types = {f.name: f.type for f in dataclasses.fields(cls)}
        for part in (spec or "").replace(";", ",").split(","):
            part = part.strip()
            if not part:
                continue
            try:
                key, sep, val = part.partition("=")
                key, val = key.strip(), val.strip()
                if not sep or key not in types:
                    raise ValueError(f"unknown key {key!r}")
                kw[key] = (float(val) if "float" in str(types[key])
                           else int(val))
            except ValueError as e:
                raise ValueError(f"bad pipeline spec entry {part!r} "
                                 f"(want key=value): {e}") from e
        return cls(**kw)


class PipelineController:
    """Owns a `Supervisor`-wrapped trainer (background thread) and an
    `EngineFleet` (with its rollout controller) against ONE workspace.
    See the module docstring for the publication state machine; the
    controller itself only *observes* the seam — the trainer's
    `on_checkpoint` hook records blessed steps for the lag gauge, and
    the rollout controller drives promotion off the checkpoint
    fingerprint entirely on its own, so neither half can wedge the
    other."""

    def __init__(self, supervisor, fleet, workspace: str,
                 spec: Optional[PipelineSpec] = None,
                 autoscale_spec=None,
                 log_fn: Optional[Callable[[str], None]] = None):
        if fleet.rollout is None:
            raise ValueError(
                "PipelineController needs a fleet built over the "
                "training workspace (EngineFleet(..., workspace=...)) "
                "— without a rollout controller no checkpoint would "
                "ever reach traffic")
        self.supervisor = supervisor
        self.fleet = fleet
        self.workspace = workspace
        self.spec = spec or PipelineSpec()
        self.log = log_fn or obs.get_logger("pipeline")
        # publication bookkeeping (all under the lock: the publish
        # hook runs on the trainer thread, lag()/snapshot() anywhere)
        self._lock = threading.Lock()
        self._blessed: Dict[int, float] = {}   # step -> publish time
        self.last_blessed_step: int = -1
        self.published = 0          # on_checkpoint firings (any verdict)
        self.unblessed = 0          # published with a non-ok verdict
        self.publish_faults = 0     # pipeline.publish site fired
        self.promote_lags_s: list = []  # blessed→served, seen at poll
        self._lag_alarmed: set = set()
        # trainer thread state
        self._thread: Optional[threading.Thread] = None
        self.train_result = None    # (params, opt_state, history)
        self.train_error: Optional[BaseException] = None
        self._train_done = threading.Event()
        # optional SLO-driven autoscaler: under pipeline mode the
        # blessed→served lag joins its pressure signals, so a fleet
        # too busy to promote is never shrunk
        self.autoscaler = None
        if autoscale_spec is not None:
            from ..serve.autoscale import AutoScaler
            self.autoscaler = AutoScaler(fleet, spec=autoscale_spec,
                                         lag_fn=self.lag,
                                         log_fn=self.log)
        supervisor.trainer.on_checkpoint = self._on_publish

    # -- lifecycle ----------------------------------------------------------
    def start(self, train_iter_factory, **run_kw) -> "PipelineController":
        """Serve first, then train: the fleet comes up on whatever the
        workspace already holds (fresh-init params at step -1 on a cold
        start), so traffic never waits on training; the trainer thread
        then runs `Supervisor.run(train_iter_factory, **run_kw)` to
        completion, publishing on its checkpoint cadence."""
        self.fleet.start()
        if self.autoscaler is not None:
            self.autoscaler.start()
        obs.emit_event("pipeline.start",
                       pinned=self.fleet.rollout.pinned_step,
                       engines=len(self.fleet.router.names()))
        self.log(f"pipeline: fleet up (pinned at step "
                 f"{self.fleet.rollout.pinned_step}); starting "
                 f"supervised training")
        self._train_done.clear()
        self._thread = threading.Thread(
            target=self._train, args=(train_iter_factory,),
            kwargs=run_kw, name="pipeline-train", daemon=True)
        self._thread.start()
        return self

    def _train(self, train_iter_factory, **run_kw) -> None:
        try:
            with obs.span("pipeline.train"):
                self.train_result = self.supervisor.run(
                    train_iter_factory, **run_kw)
        except BaseException as e:  # noqa: BLE001 — surfaced via wait()
            self.train_error = e
            self.log(f"pipeline: training FAILED "
                     f"({type(e).__name__}: {e}); the fleet keeps "
                     f"serving the last promoted step")
        finally:
            self._train_done.set()
            obs.emit_event("pipeline.train_done",
                           ok=self.train_error is None,
                           error=(repr(self.train_error)
                                  if self.train_error else None),
                           blessed_step=self.last_blessed_step)

    def train_running(self) -> bool:
        return self._thread is not None and not self._train_done.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Join the trainer (default budget `spec.join_s`).  Returns
        True when training finished — check `train_error` for how.
        The fleet keeps serving either way; `stop()` is separate."""
        if self._thread is None:
            return True
        self._thread.join(self.spec.join_s if timeout is None
                          else timeout)
        return self._train_done.is_set()

    def stop(self) -> None:
        """Stop the serving half and detach the publish hook.  The
        trainer thread is not killable — callers size train_steps (or
        use wait()) so it has finished; a still-running trainer keeps
        checkpointing into the workspace harmlessly."""
        self.supervisor.trainer.on_checkpoint = None
        if self.train_running():
            self.log("warning: pipeline stopped while training still "
                     "runs; its checkpoints will land unserved")
        if self.autoscaler is not None:
            self.autoscaler.stop()
        self.fleet.stop()

    def __enter__(self) -> "PipelineController":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- the publication seam -----------------------------------------------
    def _on_publish(self, step: int, verdict) -> None:
        """Trainer post-save hook: record the publication and (verdict
        ok/None) bless the step for the lag gauge.  The `pipeline.
        publish` fault site degrades to a counted non-event — the
        rollout controller watches the fingerprint itself, so a lost
        notification never loses a promotion."""
        blessed = verdict in (None, "ok")
        with obs.span("pipeline.publish", step=step,
                      verdict=verdict, blessed=blessed):
            try:
                faults.maybe_fault("pipeline.publish")
            except Exception as e:  # noqa: BLE001 — degrade, count
                with self._lock:
                    self.publish_faults += 1
                self.log(f"warning: pipeline publish fault at step "
                         f"{step} ({type(e).__name__}: {e}); rollout "
                         f"will pick the checkpoint up on its own "
                         f"poll")
            with self._lock:
                self.published += 1
                if blessed:
                    self._blessed[step] = time.monotonic()
                    self.last_blessed_step = max(
                        self.last_blessed_step, step)
                else:
                    self.unblessed += 1
        obs.emit_event("pipeline.publish", step=step,
                       verdict=verdict, blessed=blessed,
                       served=self.fleet.rollout.pinned_step)
        if blessed:
            self.log(f"pipeline: published blessed checkpoint step "
                     f"{step} (serving step "
                     f"{self.fleet.rollout.pinned_step})")

    # -- the lag gauge ------------------------------------------------------
    def lag(self) -> Dict[str, Any]:
        """Checkpoint-to-traffic lag, the loop's health number:
        `lag_steps` = last blessed step − served (fleet-pinned) step
        (0 when nothing is waiting), `lag_s` = seconds the OLDEST
        unserved blessed step has waited.  Blessed steps the fleet has
        caught up past are pruned here, recording their observed
        blessed→served latency in `promote_lags_s`."""
        served = self.fleet.rollout.pinned_step
        now = time.monotonic()
        with self._lock:
            for s in sorted(k for k in self._blessed if k <= served):
                self.promote_lags_s.append(now - self._blessed.pop(s))
            waiting = {s: t for s, t in self._blessed.items()
                       if s > served}
            blessed = self.last_blessed_step
        lag_steps = max(blessed - served, 0) if blessed >= 0 else 0
        lag_s = (now - min(waiting.values())) if waiting else 0.0
        if lag_s > float(self.spec.lag_alarm_s) and \
                blessed not in self._lag_alarmed:
            self._lag_alarmed.add(blessed)
            self.log(f"warning: pipeline lag alarm — blessed step "
                     f"{blessed} unserved for {lag_s:.1f}s (fleet "
                     f"pinned at {served}); the loop may be open")
            obs.emit_event("pipeline.lag_alarm", blessed=blessed,
                           served=served, lag_s=round(lag_s, 3))
        return {"blessed_step": blessed, "served_step": served,
                "lag_steps": lag_steps, "lag_s": round(lag_s, 3)}

    def register_into(self, registry,
                      prefix: str = "singa_pipeline") -> None:
        """Expose the loop through an `obs.MetricsRegistry` collector
        (/metrics): the lag pair as gauges, publications as
        counters."""
        from ..obs.metrics import Sample

        def collect():
            lag = self.lag()
            with self._lock:
                pub, unb, flt = (self.published, self.unblessed,
                                 self.publish_faults)
            return [
                Sample(f"{prefix}_blessed_step", "gauge",
                       "last health-blessed checkpoint step",
                       float(lag["blessed_step"])),
                Sample(f"{prefix}_served_step", "gauge",
                       "fleet-pinned (promoted) checkpoint step",
                       float(lag["served_step"])),
                Sample(f"{prefix}_lag_steps", "gauge",
                       "blessed minus served step",
                       float(lag["lag_steps"])),
                Sample(f"{prefix}_lag_seconds", "gauge",
                       "age of the oldest unserved blessed step",
                       float(lag["lag_s"])),
                Sample(f"{prefix}_published_total", "counter",
                       "checkpoint publications (any verdict)",
                       float(pub)),
                Sample(f"{prefix}_unblessed_total", "counter",
                       "publications with a non-ok verdict",
                       float(unb)),
                Sample(f"{prefix}_publish_faults_total", "counter",
                       "injected/real publish-hook faults survived",
                       float(flt)),
            ]

        registry.register_collector(collect)
        if self.autoscaler is not None:
            self.autoscaler.register_into(registry)

    # -- client passthrough + snapshot --------------------------------------
    def generate(self, tokens, timeout=None) -> Dict[str, Any]:
        return self.fleet.generate(tokens, timeout=timeout)

    def predict(self, tokens, timeout=None) -> Dict[str, Any]:
        return self.fleet.predict(tokens, timeout=timeout)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready view: the lag pair, publication counters, the
        trainer's supervision state, and the whole fleet snapshot."""
        lag = self.lag()
        with self._lock:
            out: Dict[str, Any] = {
                **lag,
                "published": self.published,
                "unblessed": self.unblessed,
                "publish_faults": self.publish_faults,
                "promote_lag_max_s": (round(max(self.promote_lags_s), 3)
                                      if self.promote_lags_s else None),
            }
        out["train"] = {
            "running": self.train_running(),
            "done": self._train_done.is_set(),
            "error": (repr(self.train_error) if self.train_error
                      else None),
            "failures": len(self.supervisor.failures),
        }
        out["fleet"] = self.fleet.snapshot()
        if self.autoscaler is not None:
            out["autoscale"] = self.autoscaler.snapshot()
        return out
