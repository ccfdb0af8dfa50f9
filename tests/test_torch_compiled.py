"""What surrounds the port's compiled steps, on the CPU: the chunked
`Trainer.run(scan_chunk=...)` with its deferred metrics drain, its chunk
plan against the JAX `Trainer._next_chunk_len`, `evaluate`'s single
fetch, the multi-tensor updater on device scalars against the JAX
updater, and the `graphs` switch.

The CPU has no CUDA graphs, so the graphs themselves (`core/step_graph.py`)
are held on the card by `chip_smoke.py`: phase 7 replays the train step
against eager steps bit for bit and resumes into a captured trainer, and
phase 3 replays the eval step against eager evaluation.  Everything
here runs the eager path, which is the code the graphs capture.

Tolerances: the chunked and per-step runs, and `evaluate` against
per-batch sums, must be equal to the bit (the same ops on the same
data); the updater against JAX keeps `test_torch_train.py`'s rtol 1e-5,
atol 1e-7 after 5 steps.
"""

import gc
import os
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.config.schema import UpdaterConfig as JUpdaterConfig
from singa_tpu.core import updater as jupd
from singa_tpu.core.trainer import Trainer as JTrainer
from singa_tpu.models.transformer import synthetic_token_batches
from singa_tpu.models.transformer import transformer_lm as jtransformer_lm

from singa_tpu_torch.config import load_model_config
from singa_tpu_torch.config.schema import UpdaterConfig as TUpdaterConfig
from singa_tpu_torch.core import updater as tupd
from singa_tpu_torch.core.step_graph import geometry
from singa_tpu_torch.core.trainer import Performance, Trainer
from singa_tpu_torch.models.transformer import \
    transformer_lm as ttransformer_lm
from singa_tpu_torch.utils.checkpoint import CheckpointManager
from singa_tpu_torch.weights import state_to_numpy

from port_fixture import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.port
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 128
SHAPES = {"data": {"input": (S,), "target": (S,)}}
TINY = dict(vocab_size=256, num_layers=1, embed_dim=32, num_heads=2,
            head_dim=16, seq_len=S, batchsize=2)
UPDATERS = ["kSGD", "kNesterov", "kAdaGrad", "kRMSProp", "kAdaDelta",
            "kAdam"]


def _stream(seed):
    return lambda: synthetic_token_batches(2, S, TINY["vocab_size"],
                                           seed=seed)


def _cadence(cfg, steps):
    """Test every 5 steps, validation every 7 from step 3, checkpoints
    after steps s >= 2 with (s+1) % 6 == 0, display every 3.  With
    scan_chunk 4 over 12 steps the chunks are [0-3] [4] [5] [6] [7-9]
    [10-11]: cut at a test (4, 9), a checkpoint (5, 11) and a validation
    (6) boundary, with display steps inside them."""
    cfg.train_steps, cfg.display_frequency = steps, 3
    cfg.test_steps, cfg.test_frequency = 1, 5
    cfg.validation_steps, cfg.validation_frequency = 1, 7
    cfg.validation_after_steps = 3
    cfg.checkpoint_frequency, cfg.checkpoint_after_steps = 6, 2
    return cfg


def _run(scan_chunk, workspace, steps=12):
    logs, hooked = [], []
    tr = Trainer(_cadence(ttransformer_lm(**TINY), steps), SHAPES,
                 log_fn=logs.append, device="cpu")
    fetches = []
    drain = tr.drain_metrics
    tr.drain_metrics = lambda stacked: fetches.append(
        len(next(iter(stacked.values())))) or drain(stacked)
    p, o, history = tr.run(
        *tr.init(2), _stream(7)(), test_iter_factory=_stream(8),
        val_iter_factory=_stream(9),
        hooks=[lambda s, m: hooked.append((s, dict(m)))],
        workspace=workspace, scan_chunk=scan_chunk)
    lines = [m for m in logs if m.startswith("step-")]
    return dict(state=state_to_numpy(p, o), history=history, lines=lines,
                hooked=hooked, fetches=fetches,
                saved=CheckpointManager(workspace).available_steps())


def _equal_tree(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _equal_tree(got[k], want[k])
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_chunked_run_equals_per_step_run(tmp_path):
    """`run(scan_chunk=4)` against `run(scan_chunk=0)`: params, state,
    test history, display lines (with their averages), hook steps and
    metrics in order, and checkpoint steps, all bit for bit (the
    chunked counterpart of tests/test_net.py:301)."""
    each = _run(0, str(tmp_path / "each"))
    chunked = _run(4, str(tmp_path / "chunked"))
    _equal_tree(chunked["state"][0], each["state"][0])
    _equal_tree(chunked["state"][1], each["state"][1])
    assert chunked["history"] == each["history"]
    assert [h["step"] for h in each["history"]] == [0, 5, 10]
    assert chunked["lines"] == each["lines"]
    assert [m.split(":")[0] for m in each["lines"]] == [
        "step-0 test", "step-0", "step-3", "step-5 test", "step-6",
        "step-7 validation", "step-9", "step-10 test"]
    assert chunked["hooked"] == each["hooked"]
    assert [s for s, _ in each["hooked"]] == list(range(12))
    assert chunked["saved"] == each["saved"] == [6, 12]


def test_deferred_metrics_fetch_once_per_chunk_and_per_evaluate(tmp_path):
    """One drain per chunk of the plan and one per `evaluate`, however
    many steps or batches each holds; the per-step loop drains every
    step."""
    chunked = _run(4, str(tmp_path / "chunked"))
    # evaluate: tests at 0, 5, 10 and the validation at 7, one batch each
    assert chunked["fetches"] == [1, 4, 1, 1, 1, 1, 1, 3, 1, 2]
    each = _run(0, str(tmp_path / "each"))
    assert len(each["fetches"]) == 12 + 4
    tr = Trainer(ttransformer_lm(**TINY), SHAPES, log_fn=lambda s: None,
                 device="cpu")
    calls = []
    drain = tr.drain_metrics
    tr.drain_metrics = lambda stacked: calls.append(1) or drain(stacked)
    p, _ = tr.init(1)

    def step_fn(params, batch):
        return tr.train_net.apply(params, batch, train=False)[1]
    avg = tr.evaluate(p, _stream(3)(), 5, step_fn)
    assert len(calls) == 1
    # the averages equal today's per-batch sums to the bit
    want, it = Performance(), _stream(3)()
    for _ in range(5):
        want.update(step_fn(p, next(it)))
    assert avg == want.averages()


@pytest.mark.parametrize("scan_chunk", [2, 4, 5, 16])
def test_chunk_plan_matches_jax_trainer(scan_chunk):
    """`_next_chunk_len` against the JAX Trainer's over a grid of test,
    validation and checkpoint frequencies and after-steps and run
    lengths, at every step."""
    jtr = JTrainer(jtransformer_lm(**TINY), SHAPES, log_fn=lambda s: None,
                   donate=False)
    tr = Trainer(ttransformer_lm(**TINY), SHAPES, log_fn=lambda s: None,
                 device="cpu")
    checked = 0
    for tf, ta, vf, va, cf, ts in np.ndindex(3, 2, 2, 2, 3, 2):
        fields = dict(test_frequency=(0, 3, 5)[tf],
                      test_after_steps=(0, 4)[ta],
                      validation_frequency=(0, 4)[vf],
                      validation_after_steps=(0, 6)[va],
                      checkpoint_frequency=(0, 3, 7)[cf],
                      train_steps=(10, 23)[ts])
        for cfg in (jtr.cfg, tr.cfg):
            for k, v in fields.items():
                setattr(cfg, k, v)
        for step in range(fields["train_steps"]):
            assert tr._next_chunk_len(step, scan_chunk) == \
                jtr._next_chunk_len(step, scan_chunk), (fields, step)
            checked += 1
    assert checked == 144 // 2 * (10 + 23)


@pytest.mark.parametrize("mults", [False, True])
@pytest.mark.parametrize("utype", UPDATERS)
def test_foreach_updater_matches_jax(utype, mults):
    """The multi-tensor updater against the JAX updater over 5 steps, with
    lr_scale 0.5 and a kStep schedule whose rate halves at steps 2 and 4,
    so the device scalars must be written at the right step; with and
    without per-param Multipliers (three params in two groups)."""
    kw = dict(type=utype, base_learning_rate=0.1, momentum=0.9,
              weight_decay=0.01, learning_rate_change_method="kStep",
              learning_rate_change_frequency=2, gamma=0.5, rho=0.95,
              delta=1e-6)
    ju = jupd.Updater(JUpdaterConfig(**kw))
    tu = tupd.Updater(TUpdaterConfig(**kw))
    ju.lr_scale = tu.lr_scale = 0.5
    rng = np.random.default_rng(UPDATERS.index(utype) * 2 + mults)
    params = {"a/w": rng.standard_normal((4, 3)).astype(np.float32),
              "b/bias": rng.standard_normal(3).astype(np.float32),
              "c/w": rng.standard_normal((2, 5)).astype(np.float32)}
    m = {"a/w": (1.0, 1.0), "b/bias": (2.0, 0.5), "c/w": (2.0, 0.5)}
    jm = ({k: jupd.Multipliers(*v) for k, v in m.items()} if mults
          else None)
    tm = ({k: tupd.Multipliers(*v) for k, v in m.items()} if mults
          else None)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = ju.init(jp), tu.init(tp)
    for step in range(5):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in params.items()}
        jp, js = ju.update(step, {k: jnp.asarray(g) for k, g in
                                  grads.items()}, jp, js, multipliers=jm)
        tgrads = {k: torch.from_numpy(g) for k, g in grads.items()}
        tu.update(step, tgrads, tp, ts, multipliers=tm)
        for k, g in grads.items():       # the caller's grads stay as given
            np.testing.assert_array_equal(tgrads[k].numpy(), g)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
        for slot in js:
            np.testing.assert_allclose(ts[slot][k].numpy(),
                                       np.asarray(js[slot][k]),
                                       rtol=1e-5, atol=1e-7, err_msg=slot)


def test_update_apply_reads_the_scalars_set_step_wrote():
    """`apply` alone replays the step `set_step` last wrote: the device
    scalars, not host floats, carry the step (what a replayed graph
    sees); `apply` before any `set_step` raises."""
    cfg = TUpdaterConfig(type="kAdam", base_learning_rate=0.1,
                         learning_rate_change_method="kStep",
                         learning_rate_change_frequency=2, gamma=0.5)
    rng = np.random.default_rng(0)
    p0 = {"w": torch.from_numpy(rng.standard_normal(6).astype(np.float32))}
    grads = {"w": torch.from_numpy(rng.standard_normal(6)
                                   .astype(np.float32))}
    a, b = tupd.Updater(cfg), tupd.Updater(cfg)
    pa, pb = ({k: v.clone() for k, v in p0.items()} for _ in range(2))
    sa, sb = a.init(pa), b.init(pb)
    with pytest.raises(RuntimeError, match="before set_step"):
        b.apply(grads, pb, sb)
    for step in (0, 3):
        a.update(step, grads, pa, sa)
        b.set_step(step, pb)
        b.apply(grads, pb, sb)
    assert torch.equal(pa["w"], pb["w"])
    assert b._scalars[("lr", 1.0)].item() == np.float32(0.05)
    assert b._scalars["c1"].item() == \
        np.float32(1) - np.power(np.float32(0.9), np.float32(4))


def test_graphs_switch():
    """graphs=True raises on the CPU, for any net; graphs=None is eager
    there.  A net that draws (alexnet.conf's crop and mirror, drop6,
    drop7) no longer picks eager steps: its trainer owns one generator
    per drawing layer on its device, which the train graphs register,
    and says nothing about running eagerly."""
    with pytest.raises(ValueError, match="needs a CUDA device"):
        Trainer(ttransformer_lm(**TINY), SHAPES, device="cpu", graphs=True)
    assert not Trainer(ttransformer_lm(**TINY), SHAPES, device="cpu").graphs
    alex = load_model_config(os.path.join(REPO, "examples", "cifar10",
                                          "alexnet.conf"))
    rgb = {"data": {"pixel": (3, 32, 32), "label": ()}}
    with pytest.raises(ValueError, match="needs a CUDA device"):
        Trainer(alex, rgb, device="cpu", graphs=True)
    logs = []
    tr = Trainer(alex, rgb, device="cpu", log_fn=logs.append)
    assert tr.graphs is False
    assert [tr.train_net.topo[i] for i in sorted(tr._gens)] == [
        "rgb", "drop6", "drop7"]
    assert all(g.device.type == "cpu" for g in tr._gens.values())
    assert not Trainer(alex, rgb, device="cpu", graphs=False,
                       log_fn=logs.append).graphs
    assert not [m for m in logs if "eagerly" in m]


def test_graph_key_is_the_batch_geometry():
    """Graphs are keyed by the path, shape and dtype of every batch leaf,
    as `compiled_scan` keys its cache (singa_tpu/core/trainer.py:499-501);
    numpy and torch leaves of one geometry share a graph."""
    a = {"data": {"input": np.zeros((2, 8), np.int32),
                  "target": np.zeros((2, 8), np.int32)}}
    assert geometry(a) == (("/data/input", (2, 8), torch.int32),
                           ("/data/target", (2, 8), torch.int32))
    assert geometry(a) != geometry({"data": {**a["data"], "target":
                                             np.zeros((2, 8), np.int64)}})
    assert geometry(a) != geometry({"data": {**a["data"], "input":
                                             np.zeros((4, 8), np.int32)}})
    t = {"data": {k: torch.from_numpy(v) for k, v in a["data"].items()}}
    assert geometry(t) == geometry(a)


def test_a_dropped_trainer_is_freed_at_once():
    """A trainer owns its graphs' params, optimizer state and memory
    pool, so it must be in no reference cycle (its eval steps are
    closures it holds): dropped, it is freed at once, not at the cycle
    collector's next pass."""
    cfg = ttransformer_lm(**TINY)
    cfg.test_steps = cfg.validation_steps = 1
    gc.disable()
    try:
        tr = Trainer(cfg, SHAPES, log_fn=lambda s: None, device="cpu")
        assert tr.test_step is not None and tr.val_step is not None
        p, o = tr.init(0)
        tr.train_step(p, o, next(_stream(1)()), 0)
        tr.evaluate(p, _stream(2)(), 1, tr.test_step)
        ref = weakref.ref(tr)
        del tr
        assert ref() is None
    finally:
        gc.enable()


def test_a_capture_keeps_what_other_threads_count():
    """Fault C8 (found by `chip_smoke.py` phase 16b on the card): a
    capture restored the whole of `_kernels.LAUNCHES` to its value from
    before its warm-up, erasing what other threads counted meanwhile;
    an engine the autoscaler grew during training took ~30 training
    steps' K1/K3/K4 launches with it (70 counted for 130).  Launches on
    a capture's stream now count into its `recording` dict, from any
    thread (the autograd engine launches the backward on one of its
    own), and its graph adds them at every replay; launches on other
    streams count in `LAUNCHES` meanwhile."""
    import threading
    from types import SimpleNamespace

    from singa_tpu_torch.ops import _kernels
    side, default = SimpleNamespace(cuda_stream=7001), 0
    before = dict(_kernels.LAUNCHES)
    inside, go, done = threading.Event(), threading.Event(), []

    def capture():
        with _kernels.recording(side) as rec:
            _kernels.add_launches({"flash_fwd": 2}, side.cuda_stream)
            inside.set()
            go.wait(10.0)
            done.append(dict(rec))

    def backward():                         # the autograd engine's thread
        _kernels.add_launches({"flash_dq": 2, "flash_dkv": 2},
                              side.cuda_stream)
    t = threading.Thread(target=capture)
    t.start()
    assert inside.wait(10.0)
    b = threading.Thread(target=backward)
    b.start()
    b.join(10.0)
    for _ in range(5):                      # another thread trains on
        _kernels.add_launches({"flash_fwd": 2, "flash_dq": 2}, default)
    go.set()
    t.join(10.0)
    assert not t.is_alive() and not b.is_alive()
    assert done == [{"flash_fwd": 2, "flash_dq": 2, "flash_dkv": 2}]
    got = {k: _kernels.LAUNCHES[k] - before[k] for k in before}
    assert got == {**{k: 0 for k in before}, "flash_fwd": 10,
                   "flash_dq": 10}
    _kernels.add_launches(done[0])          # a replay of that capture
    assert _kernels.LAUNCHES["flash_dkv"] - before["flash_dkv"] == 2
