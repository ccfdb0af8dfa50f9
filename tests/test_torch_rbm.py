"""kRBM and contrastive-divergence training (singa_tpu_torch/models/rbm.py,
`Trainer.run_cd`, the CLI on examples/mnist/rbm.conf) against the JAX
package, on the CPU.

The port's Bernoulli draws are `u < p` over uniforms from a source it is
given, so these tests give it the uniforms `jax.random.bernoulli` draws
from JAX's keys.  Tolerances, each with its reason:
- CD gradients, reconstruction error and the chain's probabilities:
  1e-5 of each array's largest magnitude (f32 products summed in another
  order; <v0 h0> - <vk hk> cancels);
- a Bernoulli sample may differ only where its uniform lies within 1e-6
  of its probability (the probabilities agree to ~1e-7), and no sample
  may differ elsewhere;
- a CD step's params and momentum: the same 1e-5 of the largest
  magnitude.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.core.net import build_net as jbuild_net
from singa_tpu.core.trainer import Trainer as JTrainer
from singa_tpu.models import rbm as jrbm

from singa_tpu_torch.config.schema import load_model_config
from singa_tpu_torch.core.layers import fold_in
from singa_tpu_torch.core.net import build_net
from singa_tpu_torch.core.trainer import Trainer
from singa_tpu_torch.data.synthetic import synthetic_image_batches
from singa_tpu_torch.models import rbm
from singa_tpu_torch.utils.checkpoint import CheckpointManager
from singa_tpu_torch.weights import numpy_params, params_from_numpy

from port_fixture import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.port
REPO = __file__.rsplit("/tests/", 1)[0]
SHAPES = {"data": {"pixel": (28, 28), "label": ()}}


def _close(got, want, what, tol=1e-5):
    want = np.asarray(want, np.float32)
    top = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=tol * top, err_msg=what)


def _jax_uniforms(key, k, b, nvis, nhid):
    """The uniforms JAX's CD-k chain draws from `key`, in the order the
    port takes them: per Gibbs step the hidden units', then the visible
    units' (`_cd_grads` splits the key k ways, each into (kh, kv), and
    `bernoulli(kx, p)` is `uniform(kx, p.shape) < p`)."""
    out = []
    for sub in jax.random.split(key, k):
        kh, kv = jax.random.split(sub)
        out.append(np.asarray(jax.random.uniform(kh, (b, nhid))))
        out.append(np.asarray(jax.random.uniform(kv, (b, nvis))))
    return out


def _source(arrays):
    it = iter(arrays)

    def draw(shape):
        u = torch.from_numpy(np.array(next(it)))
        assert tuple(u.shape) == tuple(shape)
        return u
    return draw


def test_krbm_layer_registers_and_forwards():
    """rbm_mnist's net (tests/test_rbm_config.py:16-27): shapes, params
    with JAX's names and defaults, and a forward in [0, 1] equal to the
    JAX net's on the same weights."""
    cfg = rbm.rbm_mnist(widths=(32, 16), batchsize=8, train_steps=10)
    jcfg = jrbm.rbm_mnist(widths=(32, 16), batchsize=8, train_steps=10)
    net = build_net(cfg, "kTrain", SHAPES)
    jnet = jbuild_net(jcfg, "kTrain", SHAPES)
    assert net.shapes["rbm0"] == (8, 32) and net.shapes["rbm1"] == (8, 16)
    assert sorted(net.param_specs) == sorted(jnet.param_specs) == [
        "rbm0/hbias", "rbm0/vbias", "rbm0/weight", "rbm1/hbias",
        "rbm1/vbias", "rbm1/weight"]
    layer = net.layers["rbm0"]
    assert layer.is_rbm and (layer.nvis, layer.nhid, layer.cd_k) == \
        (784, 32, 1) and not layer.persistent
    jparams = jnet.init_params(jax.random.PRNGKey(0))
    arrays = {k: np.asarray(v) for k, v in jparams.items()}
    params = params_from_numpy(net, arrays, device="cpu")
    batch = next(synthetic_image_batches(8, seed=3, stream_seed=30))
    _, _, jout = jnet.apply(jparams, jax.tree_util.tree_map(jnp.asarray,
                                                            batch),
                            train=False)
    _, _, out = net.apply(params, batch, train=False)
    h = out["rbm1"].numpy()
    assert h.shape == (8, 16) and (h >= 0).all() and (h <= 1).all()
    for name in ("rbm0", "rbm1"):
        _close(out[name].numpy(), jout[name], name)


def test_krbm_params_init_and_carry_across():
    """`init_params` and `numpy_params` draw kRBM's params as the JAX
    layer declares them (weight N(0, 0.01²), vbias and hbias 0);
    `params_from_numpy` and `init_rbm` carry the same layout."""
    cfg = load_model_config(f"{REPO}/examples/mnist/rbm.conf")
    net = build_net(cfg, "kTrain", SHAPES)
    for params in (net.init_params(0, device="cpu"),
                   params_from_numpy(net, numpy_params(net, 0),
                                     device="cpu")):
        assert params["rbm0/weight"].shape == (784, 250)
        assert params["rbm1/weight"].shape == (250, 100)
        assert abs(params["rbm0/weight"].std().item() - 0.01) < 0.001
        for k in ("rbm0/vbias", "rbm0/hbias", "rbm1/vbias", "rbm1/hbias"):
            assert not params[k].any(), k
    jp = jrbm.init_rbm(jax.random.PRNGKey(0), 784, 250)
    tp = rbm.init_rbm(torch.Generator().manual_seed(0), 784, 250)
    for k in ("W", "bv", "bh"):
        assert tp[k].shape == jp[k].shape
    assert abs(tp["W"].std().item() - float(jnp.std(jp["W"]))) < 0.001


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("pcd", [False, True])
def test_cd_grads_match_jax(k, pcd):
    """cd_grads with JAX's uniforms: grads, reconstruction error and the
    chain's end; Bernoulli samples differ only at near-ties."""
    b, nvis, nhid = 8, 60, 24
    rng = np.random.default_rng(10 * k + pcd)
    params = {"W": (0.3 * rng.standard_normal((nvis, nhid))).astype(
                  np.float32),
              "bv": (0.1 * rng.standard_normal(nvis)).astype(np.float32),
              "bh": (0.1 * rng.standard_normal(nhid)).astype(np.float32)}
    v0 = rng.random((b, nvis)).astype(np.float32)
    chain = (rng.random((b, nvis)) < 0.5).astype(np.float32) if pcd else None
    key = jax.random.PRNGKey(k)
    jg, jrecon, jend = jrbm.cd_grads(
        {n: jnp.asarray(a) for n, a in params.items()}, jnp.asarray(v0), key,
        k=k, persistent=None if chain is None else jnp.asarray(chain))
    us = _jax_uniforms(key, k, b, nvis, nhid)
    tparams = {n: torch.from_numpy(a) for n, a in params.items()}
    tg, trecon, tend = rbm.cd_grads(
        tparams, torch.from_numpy(v0), _source(us), k=k,
        persistent=None if chain is None else torch.from_numpy(chain))
    # the chain step by step from JAX's states: every sample the port
    # takes from the same probabilities and uniforms, flips counted
    near = far = 0
    v = v0 if chain is None else chain
    for i in range(k):
        for which, u in (("h", us[2 * i]), ("v", us[2 * i + 1])):
            src = torch.from_numpy(np.array(v))
            p = (rbm._h_prob(tparams, src) if which == "h"
                 else rbm._v_prob(tparams, src)).numpy()
            jp = np.asarray(jrbm._h_prob(params, v) if which == "h"
                            else jrbm._v_prob(params, v))
            _close(p, jp, f"{which} probabilities, step {i}")
            flip = (u < p) != (u < jp)
            tie = np.abs(u - jp) < 1e-6
            near += int((flip & tie).sum())
            far += int((flip & ~tie).sum())
            v = (u < jp).astype(np.float32)
    assert far == 0, (near, far)
    assert near == 0, "a near-tie flip: the end-to-end comparison is moot"
    for n in ("W", "bv", "bh"):
        _close(tg[n].numpy(), jg[n], f"grad {n}")
    _close(trecon.numpy(), jrecon, "recon")
    np.testing.assert_array_equal(tend.numpy(), np.asarray(jend))


def test_stacking_helpers_match_jax():
    """free_energy, unroll_autoencoder and autoencoder_apply against the
    JAX package's on the same stacked weights; greedy_pretrain stacks
    RBMs of the given widths, each on the one below's hidden
    probabilities."""
    rng = np.random.default_rng(3)
    sizes = (30, 12, 6)
    stack = [{"W": (0.5 * rng.standard_normal((a, b))).astype(np.float32),
              "bv": (0.1 * rng.standard_normal(a)).astype(np.float32),
              "bh": (0.1 * rng.standard_normal(b)).astype(np.float32)}
             for a, b in zip(sizes[:-1], sizes[1:])]
    v = rng.random((5, 30)).astype(np.float32)
    jstack = [{k: jnp.asarray(a) for k, a in p.items()} for p in stack]
    tstack = [{k: torch.from_numpy(a) for k, a in p.items()} for p in stack]
    _close(rbm.free_energy(tstack[0], torch.from_numpy(v)).numpy(),
           jrbm.free_energy(jstack[0], jnp.asarray(v)), "free energy")
    tun, jun = rbm.unroll_autoencoder(tstack), jrbm.unroll_autoencoder(jstack)
    assert sorted(tun) == sorted(jun)
    _close(rbm.autoencoder_apply(tun, torch.from_numpy(v), 2).numpy(),
           jrbm.autoencoder_apply(jun, jnp.asarray(v), 2), "reconstruction")

    def data():
        g = np.random.default_rng(0)
        while True:
            yield torch.from_numpy((g.random((8, 30)) < 0.3)
                                   .astype(np.float32))
    logs = []
    rbms = rbm.greedy_pretrain(torch.Generator().manual_seed(0), data,
                               (12, 6), 30, steps_per_layer=5,
                               log_fn=logs.append)
    assert [tuple(p["W"].shape) for p in rbms] == [(30, 12), (12, 6)]
    assert logs == ["pretraining RBM 0: 30 -> 12",
                    "pretraining RBM 1: 12 -> 6"]


def _cd_pair(monkeypatch, **kw):
    """(JAX trainer, port trainer, numpy weights) of one rbm_mnist net,
    the port's chain uniforms replaced by JAX's for each step."""
    cfg = rbm.rbm_mnist(**kw)
    jcfg = jrbm.rbm_mnist(**kw)
    jtr = JTrainer(jcfg, SHAPES, log_fn=lambda s: None, donate=False)
    tr = Trainer(cfg, SHAPES, log_fn=lambda s: None, device="cpu")
    arrays = numpy_params(tr.train_net, seed=1)
    arrays = {k: v * 30 if k.endswith("weight") else v + 0.05
              for k, v in arrays.items()}
    return jtr, tr, arrays


def _jax_cd_step(jtr, params, opt, batch, step, idx, chain=None, seed=0):
    """The arithmetic of the JAX `run_cd`'s `cd_step`
    (singa_tpu/core/trainer.py:1160-1181), unjitted: the prefix forward
    at train=False, cd_grads from fold_in(PRNGKey(seed ^ 0xCD), step),
    and the updater on the RBM's params only."""
    net = jtr.train_net
    names = [n for n in net.topo if getattr(net.layers[n], "is_rbm", False)]
    layer = net.layers[names[idx]]
    prefix = net.topo[:net.topo.index(names[idx])]
    _, _, outs = net.apply(params, batch, train=False, layer_subset=prefix)
    v = outs[layer.cfg.srclayers[0]]
    v = v.reshape(v.shape[0], -1).astype(jnp.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(seed ^ 0xCD), step)
    grads, recon, end = jrbm.cd_grads(layer.cd_view(params), v, key,
                                      k=layer.cd_k, persistent=chain)
    named = layer.named_grads(grads)
    new_p, new_s = jtr.updater.update(
        step, named, {k: params[k] for k in named},
        {sk: {k: sv[k] for k in named} for sk, sv in opt.items()},
        multipliers={k: jtr.multipliers[k] for k in named})
    return ({**params, **new_p},
            {sk: {**opt[sk], **new_s[sk]} for sk in opt}, recon, end, key,
            layer)


@pytest.mark.parametrize("persistent", [False, True])
def test_cd_steps_match_jax_arithmetic(monkeypatch, persistent):
    """Three CD steps of rbm1 (prefix forward through rbm0, CD-1, kSGD
    with momentum 0.5 on rbm1's params only) from the same weights and
    draws: params, momentum and recon against the JAX step's; rbm0's
    params untouched.  With PCD the chain starts from the data (`fresh`)
    and carries."""
    jtr, tr, arrays = _cd_pair(monkeypatch, widths=(40, 24), batchsize=8,
                               train_steps=6)
    tr.train_net.layers["rbm1"].persistent = persistent
    jp = {k: jnp.asarray(v) for k, v in arrays.items()}
    jo = jtr.updater.init(jp)
    tp = params_from_numpy(tr.train_net, arrays, device="cpu")
    to = tr.updater.init(tp)
    data = synthetic_image_batches(8, seed=3, stream_seed=30)
    injected = []
    real = rbm.cd_grads

    def cd_grads(params, v0, rng, k=1, persistent=None):
        return real(params, v0, _source(injected.pop(0)), k, persistent)
    monkeypatch.setattr(rbm, "cd_grads", cd_grads)
    chain = None
    for step in range(3, 6):
        batch = next(data)
        jp, jo, jrecon, jend, key, layer = _jax_cd_step(
            jtr, jp, jo, jax.tree_util.tree_map(jnp.asarray, batch), step,
            1, chain)
        if persistent:
            chain = jend
        injected.append(_jax_uniforms(key, 1, 8, 40, 24))
        tp, to, m = tr.cd_step(tp, to, batch, step, 1, fresh=step == 3)
        _close(m["recon"].numpy(), jrecon, f"recon {step}")
        if persistent:
            np.testing.assert_array_equal(tr._chains[1].numpy(),
                                          np.asarray(jend))
    for k in arrays:
        _close(tp[k].numpy(), jp[k], k)
        _close(to["history"][k].numpy(), jo["history"][k], f"history {k}")
        if k.startswith("rbm0"):
            np.testing.assert_array_equal(tp[k].numpy(), arrays[k])


def _run(cfg, steps=None, start=0, params=None, opt=None, ws=None,
         hooks=None, logs=None, seed=0, stream=None):
    tr = Trainer(cfg, SHAPES, device="cpu", seed=seed,
                 log_fn=(logs.append if logs is not None else
                         (lambda m: None)))
    if params is None:
        params, opt = tr.init(0)
    it = stream or synthetic_image_batches(
        cfg.neuralnet.layer[0].data_param.batchsize, seed=3,
        stream_seed=30)
    out = tr.run(params, opt, it, start_step=start, workspace=ws,
                 hooks=hooks)
    return tr, out


def test_run_cd_phases_logs_and_hooks():
    """The greedy budget: step s trains RBM min(s·n // total, n-1); the
    display lines name the phase's RBM; hooks get {"recon", "rbm"}; the
    history holds the display averages; recon falls in rbm0's phase and
    both RBMs move (tests/test_rbm_config.py:29-59)."""
    cfg = rbm.rbm_mnist(widths=(32, 16), batchsize=16, train_steps=90,
                        lr=0.1)
    cfg.display_frequency = 15
    seen, logs = [], []
    tr, (params, _, history) = _run(
        cfg, hooks=[lambda s, m: seen.append((s, m))], logs=logs)
    assert [m["rbm"] for _, m in seen] == [min(s * 2 // 90, 1)
                                           for s in range(90)]
    assert all(set(m) == {"recon", "rbm"} and math.isfinite(m["recon"])
               for _, m in seen)
    cd_lines = [ln for ln in logs if " cd[" in ln]
    assert cd_lines[0].startswith("step-0 cd[rbm0]: recon : ")
    assert [ln.split(" ")[1] for ln in cd_lines] == \
        ["cd[rbm0]:"] * 3 + ["cd[rbm1]:"] * 3
    assert [h["step"] for h in history] == [0, 15, 30, 45, 60, 75]
    assert history[2]["recon"] < history[0]["recon"]
    fresh = tr.train_net.init_params(0, device="cpu")
    for k in ("rbm0/weight", "rbm1/weight"):
        assert (params[k] - fresh[k]).abs().max() > 0, k
    # a chunked run logs JAX's warning and runs per step, alike
    logs2 = []
    tr2 = Trainer(cfg, SHAPES, device="cpu", log_fn=logs2.append)
    p2, o2 = tr2.init(0)
    p2, _, _ = tr2.run(p2, o2, synthetic_image_batches(16, seed=3,
                                                      stream_seed=30),
                       scan_chunk=8)
    assert any("scan_chunk is not supported for CD" in m for m in logs2)
    assert all(torch.equal(p2[k], params[k]) for k in params)


def test_run_cd_carries_the_pcd_chain():
    """persistent: the chain starts from the data at the phase's first
    step and continues from each step's end (the buffer holds the last
    end); recon still falls (tests/test_rbm_config.py:62-72)."""
    cfg = rbm.rbm_mnist(widths=(32,), batchsize=16, train_steps=60, lr=0.1)
    cfg.neuralnet.layer[2].rbm_param.persistent = True
    cfg.display_frequency = 20
    tr, (params, opt, history) = _run(cfg)
    assert history[-1]["recon"] < history[0]["recon"]
    # the same steps by hand: cd_grads from the buffer's last end
    tr2 = Trainer(cfg, SHAPES, device="cpu", log_fn=lambda m: None)
    p, o = tr2.init(0)
    it = synthetic_image_batches(16, seed=3, stream_seed=30)
    layer = tr2.train_net.layers["rbm0"]
    for step in range(60):
        batch = next(it)
        start = None if step == 0 else tr2._chains[0].clone()
        v0 = tr2._cd_input(p, batch, "rbm0")
        gen = torch.Generator().manual_seed(fold_in(0 ^ 0xCD, step))
        _, _, end = rbm.cd_grads(layer.cd_view(p), v0, gen, k=1,
                                 persistent=start)
        p, o, _ = tr2.cd_step(p, o, batch, step, 0, fresh=step == 0)
        assert torch.equal(tr2._chains[0], end), step
    assert all(torch.equal(p[k], params[k]) for k in params)


def test_run_cd_checkpoints_and_resumes(tmp_path):
    """Saves at the cadence and at the end, once each
    (tests/test_rbm_config.py:75-81; the JAX run_cd saves the last step
    twice); a run resumed from step 10 ends where an uninterrupted one
    does (plain CD: no chain to restart)."""
    cfg = rbm.rbm_mnist(widths=(16, 8), batchsize=8, train_steps=20,
                        lr=0.1)
    cfg.checkpoint_frequency = 10
    ws = str(tmp_path / "ws")
    _, (full, _, _) = _run(cfg, ws=ws)
    mgr = CheckpointManager(ws, log_fn=lambda m: None)
    assert mgr.latest_step() == 20
    assert sorted(mgr.available_steps()) == [10, 20]
    tr = Trainer(cfg, SHAPES, device="cpu", log_fn=lambda m: None)
    p, o = tr.init(0)
    p, o, start = tr.resume(p, o, ws)
    assert start == 20
    rp, ro, step = mgr.restore(10)
    assert step == 10
    p = params_from_numpy(tr.train_net, rp, device="cpu")
    o = {s: params_from_numpy(tr.train_net, d, device="cpu")
         for s, d in ro.items()}
    it = synthetic_image_batches(8, seed=3, stream_seed=30)
    for _ in range(10):
        next(it)
    p, o, _ = tr.run(p, o, it, start_step=10)
    assert all(torch.equal(p[k], full[k]) for k in full)


def test_rbm_conf_trains_through_the_cli(tmp_path, capsys):
    """`python -m singa_tpu_torch.main -model_conf examples/mnist/rbm.conf
    --synthetic` (batch 64, 784-250-100): exit 0, both phases, and under
    the Supervisor with a workspace."""
    from singa_tpu_torch.main import main
    conf = f"{REPO}/examples/mnist/rbm.conf"
    assert main(["-model_conf", conf, "--synthetic", "--steps", "6"],
                device="cpu") == 0
    out = capsys.readouterr().out
    assert "step-0 cd[rbm0]: recon : " in out
    assert "training done: recon : " in out
    ws = str(tmp_path / "ws")
    assert main(["-model_conf", conf, "--synthetic", "--steps", "6",
                 "--workspace", ws, "--max-restarts", "1"],
                device="cpu") == 0
    assert CheckpointManager(ws, log_fn=lambda m: None).latest_step() == 6
