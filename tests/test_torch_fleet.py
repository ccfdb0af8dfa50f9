"""The port's serving fleet (`singa_tpu_torch/serve/fleet.py`) over real
engines on the CPU: a tiny dense LM (2 layers, E=32, V=64, f32) with
numpy-seeded weights, as `tests/test_fleet.py` serves it.

- Fault C5: engines built over one params dict own their storage, so
  reloading one leaves the other's params and greedy answers as they
  were (`InferenceEngine` used to keep the caller's tensors when they
  already lay on its device, and a reload copies into the live ones).
- The rollout on real engines, ticked by hand: a healthy save reaches
  exactly one engine, then both; a diverged save reaches one and is
  rolled back; a canary that dies mid-canary is rolled back while the
  survivor serves.  No request fails, and the fleet's answers equal
  the JAX package's engine on the same weights.
- Elastic membership: `grow()` joins a warmed engine at the pinned step
  and `retire()` drains it; an `AutoScaler` tick grows the real fleet.
- The CLI: `serve --fleet 2 --smoke 4` exits 0 with 4 requests served,
  and the fleet flags' misuse exits 2 as the JAX CLI's does."""

import json
import os
import tempfile
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.core.net import build_net as jbuild_net
from singa_tpu.models.transformer import transformer_lm as jtransformer_lm
from singa_tpu.serve import InferenceEngine as JEngine
from singa_tpu.serve import ServeSpec as JSpec

import singa_tpu_torch.main as tmain
from singa_tpu_torch.core.net import build_net
from singa_tpu_torch.models.transformer import transformer_lm
from singa_tpu_torch.serve import (AutoScaler, AutoScaleSpec, EngineFleet,
                                   InferenceEngine, RolloutSpec, RouterSpec,
                                   ServeSpec, left_pad)
from singa_tpu_torch.utils.checkpoint import CheckpointManager
from singa_tpu_torch.weights import numpy_params, params_from_numpy

pytestmark = pytest.mark.port
VOCAB, SEQ = 64, 16
CFG = dict(vocab_size=VOCAB, num_layers=2, embed_dim=32, num_heads=4,
           head_dim=8, seq_len=SEQ, batchsize=2)
SHAPES = {"data": {"input": (SEQ,), "target": (SEQ,)}}
SPEC = dict(buckets=((2, 8),), max_new_tokens=6, batch_window_s=0.002,
            request_timeout_s=30.0)
QUIET = dict(log_fn=lambda s: None)
CONF = os.path.join(os.path.dirname(__file__), "..", "examples",
                    "transformer", "lm_tiny.conf")
PROMPTS = [np.array(p, np.int32) for p in
           ([3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9, 7, 9], [2])]


@pytest.fixture(scope="module")
def tiny():
    net = build_net(transformer_lm(**CFG), "kTest", SHAPES)
    seeds = {s: numpy_params(net, seed=s) for s in (0, 1, 2)}
    return net, seeds


def _jax_answers(arrays):
    """Greedy answers of the JAX package's engine on `arrays`."""
    jnet = jbuild_net(jtransformer_lm(**CFG), "kTest", SHAPES)
    eng = JEngine(jnet, JSpec(**SPEC),
                  params={k: jnp.asarray(v) for k, v in arrays.items()},
                  **QUIET)
    return [list(map(int, eng.run_batch("generate", *_batch(p))[0]))
            for p in PROMPTS]


def _batch(prompt):
    return left_pad([prompt], SPEC["buckets"][0])


def _answers(eng):
    return [list(map(int, eng.run_batch("generate", *_batch(p))[0]))
            for p in PROMPTS]


def _save(ws, step, arrays, verdict="ok"):
    CheckpointManager(ws, log_fn=lambda s: None).save(
        step, arrays, {"t": np.zeros((), np.float32)},
        health={"verdict": verdict})


def _steps(fleet):
    return sorted(fleet.router.handle_for(n).engine.params_step
                  for n in fleet.router.names())


# -- fault C5 -------------------------------------------------------------------

def test_engines_over_one_params_dict_do_not_share_storage(tiny):
    net, seeds = tiny
    params = params_from_numpy(net, seeds[0], device="cpu")
    with tempfile.TemporaryDirectory() as ws:
        _save(ws, 1, seeds[1])
        e0, e1 = (InferenceEngine(net, ServeSpec(**SPEC), params,
                                  device="cpu", workspace=ws, pinned=True,
                                  **QUIET) for _ in range(2))
        for k, v in params.items():
            ptrs = {v.data_ptr(), e0.params[k].data_ptr(),
                    e1.params[k].data_ptr()}
            assert len(ptrs) == 3, k
        before = {k: v.clone() for k, v in e1.params.items()}
        want = _answers(e1)
        assert e0.reload_to(1) == "reloaded" and e0.params_step == 1
        for k, v in e1.params.items():
            assert torch.equal(v, before[k]), k
            assert torch.equal(params[k], before[k]), k
        assert e1.params_step == -1 and _answers(e1) == want
        # the reloaded engine serves step 1's weights: the JAX engine's
        # answers on them
        assert _answers(e0) == _jax_answers(seeds[1])
        assert _answers(e0) != want


def test_a_local_fleet_gives_each_member_its_own_params(tiny):
    net, seeds = tiny
    params = params_from_numpy(net, seeds[0], device="cpu")
    fleet = EngineFleet.local(net, ServeSpec(**SPEC), 2, params=params,
                              device="cpu", **QUIET)
    engines = [fleet.router.handle_for(n).engine
               for n in fleet.router.names()]
    for k in params:
        assert len({params[k].data_ptr()}
                   | {e.params[k].data_ptr() for e in engines}) == 3


# -- the rollout on real engines ------------------------------------------------

def _fleet(net, ws, params, size=2, **ro):
    ro.setdefault("window_s", 0.05)
    return EngineFleet.local(
        net, ServeSpec(**SPEC), size, workspace=ws, params=params,
        router_spec=RouterSpec(probe_period_s=0.05, quarantine_after=1,
                               readmit_base_s=0.05, hedge="off"),
        rollout_spec=RolloutSpec(poll_s=60.0, **ro), device="cpu",
        **QUIET)


def _serve(fleet, n=4):
    return [fleet.generate(PROMPTS[i % len(PROMPTS)])["tokens"]
            for i in range(n)]


def test_rollout_canaries_one_engine_then_promotes_or_rolls_back(tiny):
    net, seeds = tiny
    params = params_from_numpy(net, seeds[0], device="cpu")
    with tempfile.TemporaryDirectory() as ws:
        _save(ws, 1, seeds[0])
        fleet = _fleet(net, ws, params).start()
        ctrl = fleet.rollout
        ctrl.stop()                     # ticks by hand from here
        try:
            assert _steps(fleet) == [1, 1] and ctrl.pinned_step == 1
            _save(ws, 2, seeds[1])
            ctrl.tick()
            assert ctrl.state == "CANARY" and _steps(fleet) == [1, 2]
            _serve(fleet)
            time.sleep(0.1)
            ctrl.tick()
            assert ctrl.promotions == 1 and _steps(fleet) == [2, 2]
            got = [fleet.generate(p)["tokens"] for p in PROMPTS]
            assert got == _jax_answers(seeds[1])
            _save(ws, 3, seeds[2], verdict="diverged")
            ctrl.tick()
            assert ctrl.state == "CANARY" and _steps(fleet) == [2, 3]
            _serve(fleet)
            time.sleep(0.1)
            ctrl.tick()
            assert ctrl.rollbacks == 1 and _steps(fleet) == [2, 2]
            assert ctrl.pinned_step == 2
            ctrl.tick()                 # the rejected save is not retried
            assert ctrl.canaries == 2 and ctrl.state == "OBSERVE"
            assert [fleet.generate(p)["tokens"] for p in PROMPTS] == got
            assert fleet.router.stats.failed == 0
        finally:
            fleet.stop()


def test_a_first_save_is_readable_between_its_rename_and_its_record(
        tiny, monkeypatch):
    """Fault C6 (found by `chip_smoke.py` phase 15b, where a first save
    of 0.44 GB takes a second to checksum): a workspace's first save
    renamed its snapshot into place before it stamped the layout
    marker, so a reader in between took the snapshot for layout 1 and
    raised `LayoutMismatchError`; the rollout counted the healthy save
    as a refused canary until the manifest changed.  The marker is
    stamped before the rename now."""
    net, seeds = tiny
    params = params_from_numpy(net, seeds[0], device="cpu")
    with tempfile.TemporaryDirectory() as ws:
        eng = InferenceEngine(net, ServeSpec(**SPEC), params, device="cpu",
                              workspace=ws, pinned=True, **QUIET)
        seen = {}
        record = CheckpointManager._manifest_record

        def between(self, step, path, health=None):
            # the moment after the rename, before the record
            seen["restored"] = CheckpointManager(
                ws, log_fn=lambda s: None).restore(step=step)[2]
            seen["reload"] = eng.reload_to(step)
            return record(self, step, path, health=health)
        monkeypatch.setattr(CheckpointManager, "_manifest_record", between)
        _save(ws, 1, seeds[1])
        assert seen == {"restored": 1, "reload": "reloaded"}
        assert eng.params_step == 1 and _answers(eng) == \
            _jax_answers(seeds[1])


def test_a_canary_that_dies_mid_canary_is_rolled_back(tiny):
    net, seeds = tiny
    params = params_from_numpy(net, seeds[0], device="cpu")
    with tempfile.TemporaryDirectory() as ws:
        _save(ws, 1, seeds[0])
        fleet = _fleet(net, ws, params, window_s=60.0).start()
        ctrl = fleet.rollout
        ctrl.stop()
        try:
            _save(ws, 2, seeds[1])
            ctrl.tick()
            assert ctrl.state == "CANARY"
            canary = fleet.router.handle_for(ctrl.canary)
            canary.kill()
            fleet.router.probe_all()    # quarantine_after=1: benched
            ctrl.tick()
            assert ctrl.state == "OBSERVE" and ctrl.rollbacks == 1
            assert ctrl.pinned_step == 1 and ctrl.canary is None
            out = [fleet.generate(p) for p in PROMPTS]
            assert {o["engine"] for o in out} == \
                set(fleet.router.names()) - {canary.name}
            assert all(o["step"] == 1 for o in out)
            assert [o["tokens"] for o in out] == _jax_answers(seeds[0])
            assert fleet.router.stats.failed == 0
        finally:
            fleet.stop()


# -- elastic membership -----------------------------------------------------------

def test_grow_joins_a_warm_engine_at_the_pinned_step_and_retire_drains(
        tiny):
    net, seeds = tiny
    params = params_from_numpy(net, seeds[0], device="cpu")
    with tempfile.TemporaryDirectory() as ws:
        _save(ws, 1, seeds[1])
        fleet = _fleet(net, ws, params, size=1).start()
        fleet.rollout.stop()
        try:
            name = fleet.grow()
            assert name == "engine-1" and _steps(fleet) == [1, 1]
            assert sorted(fleet.router.healthy_names()) == [
                "engine-0", "engine-1"]
            h = fleet.router.handle_for(name)
            assert h.request("generate", PROMPTS[0])["tokens"] == \
                _jax_answers(seeds[1])[0]
            assert fleet.retire(name) is True
            assert fleet.router.names() == ["engine-0"]
            assert not h._alive and h not in fleet._local
            # an autoscaler tick under shed pressure grows the real fleet
            sc = AutoScaler(fleet, spec=AutoScaleSpec(cooldown_s=0.0,
                                                      max_engines=2),
                            **QUIET)
            fleet.router.stats.count("routed", 10)
            fleet.router.stats.count("shed", 5)
            assert sc.tick() == "up" and len(fleet.router.names()) == 2
            assert _steps(fleet) == [1, 1]
            assert fleet.router.stats.failed == 0
        finally:
            fleet.stop()


# -- the CLI ------------------------------------------------------------------------

def test_serve_fleet_smoke_exits_0(capsys):
    argv = ["serve", "-model_conf", CONF, "--serve_spec",
            "buckets=2x16,max_new_tokens=4", "--fleet", "2", "--smoke",
            "4", "--rollout_spec", "window_s=0.5", "--fleet_spec",
            "probe_period_s=0.1", "--autoscale_spec",
            "min_engines=1,max_engines=2"]
    assert tmain.main(argv, device="cpu") == 0
    snap = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert snap["completed"] == 4 and snap["failed"] == 0
    assert snap["healthy_engines"] == 2 and "autoscale" in snap
    assert "rollout" not in snap        # no workspace, nothing to roll


@pytest.mark.parametrize("argv", [
    ["--fleet", "2", "--fleet_hostfile", "h"],
    ["--standby"],
])
def test_fleet_flag_misuse_exits_2(argv, capsys):
    assert tmain.main(["serve", "-model_conf", CONF] + argv,
                      device="cpu") == 2
    assert "error:" in capsys.readouterr().err
