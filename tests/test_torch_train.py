"""Training with the PyTorch port against the JAX package, in f32 on the
CPU: every updater under every learning-rate schedule, the whole net's
loss and every parameter gradient, a 5-step Adam trajectory of the
`Trainer`, and npz checkpoints read and written by both packages.

Inputs and weights are made with numpy (or by the JAX package) and
handed to both sides.  Tolerances, each with its reason:
- updaters: rtol 1e-5, atol 1e-7 after 5 steps — the same f32 formulas;
  the schedule's pow/cos and the op order may differ by an ulp;
- whole-net gradients: rtol 1e-3 and an atol of 1e-4 of each gradient's
  largest magnitude, as the JAX package's flash backward tests
  (tests/test_sequence.py:362-363) — the flash backward and the chunked
  head sum in another order; loss rtol 1e-5;
- Adam trajectory: loss per step rtol 1e-5; params within 1e-6 but for
  at most 0.1% of the elements, and all within 1e-4 (a third of lr) —
  Adam's first steps move each weight by about lr·g/(|g| + delta), so a
  gradient near 0 whose last bits differ moves its weight apart by up
  to ~lr (measured: 5 of 82k elements past 1e-6, the largest 1.7e-5).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.config.schema import UpdaterConfig as JUpdaterConfig
from singa_tpu.core import updater as jupd
from singa_tpu.core.net import build_net as jbuild_net
from singa_tpu.core.trainer import Trainer as JTrainer
from singa_tpu.models.transformer import synthetic_token_batches
from singa_tpu.models.transformer import transformer_lm as jtransformer_lm
from singa_tpu.utils import checkpoint as jckpt

from singa_tpu_torch.config.schema import UpdaterConfig as TUpdaterConfig
from singa_tpu_torch.core import updater as tupd
from singa_tpu_torch.core.trainer import Trainer
from singa_tpu_torch.models.transformer import \
    transformer_lm as ttransformer_lm
from singa_tpu_torch.utils import checkpoint as tckpt
from singa_tpu_torch.weights import (opt_state_from_numpy, params_from_numpy,
                                     state_to_numpy)

pytestmark = pytest.mark.port
UPDATERS = ["kSGD", "kNesterov", "kAdaGrad", "kRMSProp", "kAdaDelta",
            "kAdam"]
SCHEDULES = ["kFixed", "kLinear", "kExponential", "kInverse_t", "kInverse",
             "kStep", "kCosine", "kWarmupCosine"]


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# updaters


@pytest.mark.parametrize("method", SCHEDULES)
@pytest.mark.parametrize("utype", UPDATERS)
def test_updater_matches_jax(utype, method):
    kw = dict(type=utype, base_learning_rate=0.1, momentum=0.9,
              weight_decay=0.01, learning_rate_change_method=method,
              learning_rate_change_frequency=3, final_learning_rate=0.02,
              gamma=0.5, pow=0.75, warmup_steps=2, rho=0.95, delta=1e-6)
    jc, tc = JUpdaterConfig(**kw), TUpdaterConfig(**kw)
    rng = np.random.default_rng(UPDATERS.index(utype) * 10
                                + SCHEDULES.index(method))
    params = {"a/w": rng.standard_normal((4, 3)).astype(np.float32),
              "b/bias": rng.standard_normal(3).astype(np.float32)}
    mults = {"a/w": (1.0, 1.0), "b/bias": (2.0, 0.5)}
    ju, tu = jupd.Updater(jc), tupd.Updater(tc)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = ju.init(jp), tu.init(tp)
    jm = {k: jupd.Multipliers(*m) for k, m in mults.items()}
    tm = {k: tupd.Multipliers(*m) for k, m in mults.items()}
    for step in range(5):
        np.testing.assert_allclose(tupd.learning_rate(tc, step),
                                   float(jupd.learning_rate(jc, step)),
                                   rtol=1e-6)
        grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in params.items()}
        jp, js = ju.update(step, {k: jnp.asarray(g) for k, g in
                                  grads.items()}, jp, js, multipliers=jm)
        tu.update(step, {k: torch.from_numpy(g) for k, g in grads.items()},
                  tp, ts, multipliers=tm)
    assert set(ts) == set(js)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-7)
        for slot in js:
            np.testing.assert_allclose(ts[slot][k].numpy(),
                                       np.asarray(js[slot][k]),
                                       rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# whole net and trainer

S = 128
SHAPES = {"data": {"input": (S,), "target": (S,)}}
# test_torch_slice.py's S=128 GQA geometry
NET = dict(vocab_size=2048, num_layers=2, embed_dim=128, num_heads=4,
           num_kv_heads=2, head_dim=32, seq_len=S, batchsize=2)
SMALL = dict(vocab_size=512, num_layers=2, embed_dim=64, num_heads=4,
             num_kv_heads=2, head_dim=16, seq_len=S, batchsize=2)


def test_net_loss_and_every_gradient_match_jax():
    jnet = jbuild_net(jtransformer_lm(**NET), "kTrain", SHAPES)
    jparams = jnet.init_params(jax.random.PRNGKey(0))
    batch = next(synthetic_token_batches(2, S, NET["vocab_size"], seed=3))

    def loss_fn(p):
        return jnet.apply(p, jax.tree_util.tree_map(jnp.asarray, batch),
                          train=True)[0]
    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    tr = Trainer(ttransformer_lm(**NET), SHAPES, device="cpu")
    tparams = params_from_numpy(tr.train_net, _host(jparams), device="cpu")
    metrics, grads = tr.gradients(tparams, batch)
    np.testing.assert_allclose(float(metrics["loss"]), float(jl), rtol=1e-5)
    assert set(grads) == set(jg)
    for k, g in grads.items():
        assert g is not None, k
        want = np.asarray(jg[k])
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-3,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=k)


def test_adam_trajectory_matches_jax_trainer():
    """5 steps of `Trainer.train_step` from the JAX Trainer's init (params
    and Adam state carried across with `weights`) against the JAX
    Trainer's own steps on the same batches."""
    jtr = JTrainer(jtransformer_lm(**SMALL), SHAPES, log_fn=lambda s: None,
                   donate=False)
    jp, jo = jtr.init(0)
    tr = Trainer(ttransformer_lm(**SMALL), SHAPES, device="cpu")
    tp = params_from_numpy(tr.train_net, _host(jp), device="cpu")
    to = opt_state_from_numpy(tr.train_net, _host(jo), device="cpu")
    data = synthetic_token_batches(2, S, SMALL["vocab_size"], seed=4)
    rng = jax.random.PRNGKey(0)
    for step in range(5):
        batch = next(data)
        jp, jo, jm = jtr.train_step(
            jp, jo, jax.tree_util.tree_map(jnp.asarray, batch), step, rng)
        tp, to, tm = tr.train_step(tp, to, batch, step)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"step {step}")
    got_p, got_o = state_to_numpy(tp, to)
    gaps = np.concatenate([np.abs(got_p[k] - np.asarray(jp[k])).ravel()
                           for k in sorted(got_p)])
    assert gaps.max() <= 1e-4 and np.mean(gaps > 1e-6) <= 1e-3, \
        (gaps.max(), int(np.sum(gaps > 1e-6)))
    assert set(got_o) == set(jo) == {"history", "update"}


# ---------------------------------------------------------------------------
# checkpoints


def _state(v):
    rng = np.random.default_rng(v)
    params = {"embed/embedding": rng.standard_normal((8, 4))
              .astype(np.float32),
              "ln/scale": np.full(4, float(v), np.float32)}
    return params, {slot: {k: rng.standard_normal(a.shape).astype(np.float32)
                           for k, a in params.items()}
                    for slot in ("history", "update")}


def _equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _equal(got[k], want[k])
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k])


def test_snapshots_cross_between_packages(tmp_path, monkeypatch):
    """A port snapshot (saved from tensors) restores in the JAX
    CheckpointManager's npz path, and a JAX snapshot in the port."""
    monkeypatch.setattr(jckpt, "_HAVE_ORBAX", False)
    ws = str(tmp_path)
    p1, o1 = _state(1)
    tckpt.CheckpointManager(ws).save(
        7, {k: torch.from_numpy(v) for k, v in p1.items()},
        {s: {k: torch.from_numpy(v) for k, v in d.items()}
         for s, d in o1.items()})
    jm = jckpt.CheckpointManager(ws, log_fn=lambda s: None)
    rp, ro, step = jm.restore()
    assert step == 7
    _equal(rp, p1)
    _equal(ro, o1)
    p2, o2 = _state(2)
    jm.save(9, p2, o2)
    tm = tckpt.CheckpointManager(ws)
    assert tm.available_steps() == [7, 9] and tm.latest_step() == 9
    rp, ro, step = tm.restore()
    assert step == 9
    _equal(rp, p2)
    _equal(ro, o2)
    rp, _, step = tm.restore(step=8)
    assert step == 7
    _equal(rp, p1)


def test_restore_walks_back_past_torn_and_corrupt_snapshots(tmp_path):
    logs = []
    mgr = tckpt.CheckpointManager(str(tmp_path), log_fn=logs.append)
    for v in (1, 2, 3):
        mgr.save(v, *_state(v))
    # step 3 torn (truncated to half), step 2 with one byte flipped:
    # the manifest's size and sha256 catch both
    path3 = os.path.join(mgr.dir, "step_3.npz")
    with open(path3, "r+b") as f:
        f.truncate(os.path.getsize(path3) // 2)
    path2 = os.path.join(mgr.dir, "step_2.npz")
    with open(path2, "r+b") as f:
        f.seek(100)
        byte = f.read(1)
        f.seek(100)
        f.write(bytes([byte[0] ^ 0xFF]))
    rp, _, step = mgr.restore()
    assert step == 1
    _equal(rp, _state(1)[0])
    assert sum("corrupt or partial" in m for m in logs) == 2
    assert not any(n.endswith(".tmp") for n in os.listdir(mgr.dir))


def test_layout_mismatch_raises(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save(1, *_state(1))
    with open(os.path.join(mgr.dir, "LAYOUT_VERSION"), "w") as f:
        f.write("1")
    with pytest.raises(tckpt.LayoutMismatchError):
        mgr.restore()
    with pytest.raises(tckpt.LayoutMismatchError):
        mgr.save(2, *_state(2))


def test_fingerprint_and_load_pretrained(tmp_path):
    ws = str(tmp_path)
    mgr = tckpt.CheckpointManager(ws)
    assert mgr.restore() is None and mgr.latest_step() is None
    empty = mgr.fingerprint()
    mgr.save(4, *_state(4))
    fp = mgr.fingerprint()
    assert fp != empty and fp[0] == (4,) and mgr.fingerprint() == fp
    fresh = {"embed/embedding": np.zeros((8, 4), np.float32),
             "head/w": np.ones((4, 2), np.float32)}
    merged, _, step = tckpt.load_pretrained(ws, fresh, {})
    assert step == 4
    np.testing.assert_array_equal(merged["embed/embedding"],
                                  _state(4)[0]["embed/embedding"])
    np.testing.assert_array_equal(merged["head/w"], fresh["head/w"])


def test_run_resume_continue_equals_uninterrupted(tmp_path):
    k, total = 2, 4

    def trainer(steps):
        cfg = ttransformer_lm(**SMALL)
        cfg.train_steps, cfg.checkpoint_frequency = steps, k
        cfg.display_frequency = 0
        return Trainer(cfg, SHAPES, log_fn=lambda s: None, device="cpu")

    def data(skip=0):
        it = synthetic_token_batches(2, S, SMALL["vocab_size"], seed=5)
        for _ in range(skip):
            next(it)
        return it

    whole = trainer(total)
    pa, oa, _ = whole.run(*whole.init(3), data())
    first = trainer(k)
    first.run(*first.init(3), data(), workspace=str(tmp_path))
    assert tckpt.CheckpointManager(str(tmp_path)).available_steps() == [k]
    again = trainer(total)
    pc, oc, at = again.resume(*again.init(99), str(tmp_path))
    assert at == k
    pc, oc, _ = again.run(pc, oc, data(k), start_step=k)
    got, want = state_to_numpy(pc, oc), state_to_numpy(pa, oa)
    _equal(got[0], want[0])
    _equal(got[1], want[1])


TINY = dict(vocab_size=256, num_layers=1, embed_dim=32, num_heads=2,
            head_dim=16, seq_len=S, batchsize=2)


def test_train_steps_stacked_equals_per_step_calls():
    tr = Trainer(ttransformer_lm(**TINY), SHAPES, device="cpu")
    data = synthetic_token_batches(2, S, TINY["vocab_size"], seed=6)
    batches = [next(data) for _ in range(3)]
    stacked = {"data": {f: np.stack([b["data"][f] for b in batches])
                        for f in ("input", "target")}}
    pa, oa = tr.init(1)
    pa, oa, ms = tr.train_steps(pa, oa, stacked, 0, 3, stacked=True)
    pb, ob = tr.init(1)
    losses = []
    for step, batch in enumerate(batches):
        pb, ob, m = tr.train_step(pb, ob, batch, step)
        losses.append(m["loss"])
    assert torch.equal(ms["loss"], torch.stack(losses))
    _equal(state_to_numpy(pa)[0], state_to_numpy(pb)[0])
    with pytest.raises(ValueError, match="leading 4-axis"):
        tr.train_steps(pa, oa, stacked, 3, 4, stacked=True)


def test_run_cadence_tests_validates_and_checkpoints(tmp_path):
    """test/validation at their frequency from their after-steps, the
    display line, checkpoints after checkpoint_after_steps and at the
    end, hooks on every step (worker.h:127-160)."""
    cfg = ttransformer_lm(**TINY)
    cfg.train_steps, cfg.display_frequency = 5, 2
    cfg.test_steps, cfg.test_frequency = 1, 2
    cfg.validation_steps, cfg.validation_frequency = 1, 3
    cfg.validation_after_steps = 1
    cfg.checkpoint_frequency, cfg.checkpoint_after_steps = 2, 2
    logs, seen = [], []
    tr = Trainer(cfg, SHAPES, log_fn=logs.append, device="cpu")

    def batches(seed):
        return lambda: synthetic_token_batches(2, S, TINY["vocab_size"],
                                               seed=seed)
    p, o = tr.init(2)
    _, _, history = tr.run(p, o, batches(7)(), test_iter_factory=batches(8),
                           val_iter_factory=batches(9),
                           hooks=[lambda s, m: seen.append(s)],
                           workspace=str(tmp_path))
    assert [h["step"] for h in history] == [0, 2, 4]
    assert set(history[0]) == {"step", "loss", "precision"}
    assert sum("validation:" in m for m in logs) == 1       # step 3
    assert [m.split(":")[0] for m in logs if m.startswith("step-")
            and "test" not in m and "validation" not in m] == \
        ["step-0", "step-2", "step-4"]
    assert seen == [0, 1, 2, 3, 4]
    # (s+1) % 2 == 0 from s >= 2: step 4 saved at s=3, and the final 5
    assert tckpt.CheckpointManager(str(tmp_path)).available_steps() == [4, 5]
