"""kMoE in the port against the JAX package, on the CPU: `moe_ffn` and
its gradients in f32 (capacity drops and tied experts included), the
bf16 layer path, the top-k tie order (lowest index first, as
`jax.lax.top_k`) in the loss metric, one Adam step of
`examples/transformer/lm.conf` with only batch and sequence shrunk, the
aux loss through every Trainer path, and npz checkpoints of a MoE net
read and written by both packages.

Inputs and weights are made with numpy (or by the JAX package) and
handed to both sides.  Tolerances, each with its reason:
- `moe_ffn` in f32: output and aux 1e-5 (the same f32 formulas; the
  router and expert products sum in another order); gradients 1e-4 of
  each one's largest magnitude (the scatter-adds and transposed
  products sum in another order too);
- the bf16 layer: one bf16 ulp of the output's largest magnitude — both
  sides round the same f32 sums of exact bf16 products once;
- lm.conf's Adam step: loss and aux rtol 1e-5; params as
  `test_torch_train.py`'s trajectory (all within 1e-4, at most 0.1% of
  the elements past 1e-6): Adam's first step moves each weight by about
  lr·g/(|g| + delta), so a near-zero gradient whose last bits differ
  moves its weight apart by up to ~lr.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.config.schema import load_model_config as jload
from singa_tpu.core.layers import Context as JContext
from singa_tpu.core.net import build_net as jbuild_net
from singa_tpu.core.trainer import Trainer as JTrainer
from singa_tpu.models.transformer import synthetic_token_batches
from singa_tpu.models.transformer import transformer_lm as jtransformer_lm
from singa_tpu.ops.loss import topk_precision as jtopk_precision
from singa_tpu.ops.moe import moe_ffn as jmoe_ffn
from singa_tpu.utils import checkpoint as jckpt

from singa_tpu_torch.config.schema import load_model_config as tload
from singa_tpu_torch.core.layers import Context as TContext
from singa_tpu_torch.core.net import build_net as tbuild_net
from singa_tpu_torch.core.trainer import Trainer
from singa_tpu_torch.models.transformer import \
    transformer_lm as ttransformer_lm
from singa_tpu_torch.ops.loss import topk_precision
from singa_tpu_torch.ops.moe import moe_ffn
from singa_tpu_torch.ops.topk import top_k
from singa_tpu_torch.utils import checkpoint as tckpt
from singa_tpu_torch.weights import (numpy_params, opt_state_from_numpy,
                                     params_from_numpy, state_to_numpy)

from port_fixture import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.port
LM_CONF = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "transformer", "lm.conf")
PARAMS = ("router", "w1", "b1", "w2", "b2")


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _moe_inputs(case):
    """x (2, 8, 16) and the params of 4 experts of hidden 32, as
    `tests/test_sequence.py:131`, with nonzero biases so that their
    gradients are held too."""
    rng = np.random.default_rng(["routes", "drops", "tied"].index(case))
    e, f, n = 16, 32, 4
    x = rng.standard_normal((2, 8, e)).astype(np.float32)
    p = {"router": rng.standard_normal((e, n)).astype(np.float32),
         "w1": 0.1 * rng.standard_normal((n, e, f)).astype(np.float32),
         "b1": 0.1 * rng.standard_normal((n, f)).astype(np.float32),
         "w2": 0.1 * rng.standard_normal((n, f, e)).astype(np.float32),
         "b2": 0.1 * rng.standard_normal((n, e)).astype(np.float32)}
    if case == "tied":
        # experts 1 and 2 score alike for every token, and three tokens
        # are zero (all four experts tie): the gate keeps the lower ids
        p["router"][:, 2] = p["router"][:, 1]
        x[0, :3] = 0.0
    return x, p


@pytest.mark.parametrize("case,capacity_factor", [
    ("routes", 2.0), ("drops", 0.5), ("tied", 1.25)])
def test_moe_ffn_and_gradients_match_jax(case, capacity_factor):
    x, p = _moe_inputs(case)
    cot = np.random.default_rng(9).standard_normal(x.shape).astype(
        np.float32)

    def jloss(params, xx):
        out, aux = jmoe_ffn(xx, params, 2, capacity_factor)
        return jnp.sum(out * cot) + aux, (out, aux)
    (_, (jout, jaux)), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    out, aux = moe_ffn(tx, tp, 2, capacity_factor)
    (torch.sum(out * torch.from_numpy(cot)) + aux).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5)
    grads = {**{k: tp[k].grad for k in PARAMS}, "x": tx.grad}
    want = {**jgrads[0], "x": jgrads[1]}
    for k, g in grads.items():
        w = np.asarray(want[k])
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


def test_moe_drops_reach_the_trash_row():
    """At capacity factor 0.5 some assignments are dropped: those tokens
    get only their kept expert's share (or nothing), the others the same
    output as with room for every assignment."""
    x, p = _moe_inputs("drops")
    out, _ = moe_ffn(torch.from_numpy(x),
                     {k: torch.from_numpy(v) for k, v in p.items()}, 2, 0.5)
    full, _ = moe_ffn(torch.from_numpy(x),
                      {k: torch.from_numpy(v) for k, v in p.items()}, 2, 4.0)
    differs = (out - full).abs().amax(-1) > 0
    assert 0 < int(differs.sum()) < differs.numel()


def test_moe_layer_bf16_matches_jax():
    """kMoE's apply in bf16: every param (the router too) is cast to the
    compute dtype first, then the router product runs in f32 on the
    upcast bf16 values."""
    kw = dict(vocab_size=64, num_layers=1, embed_dim=32, num_heads=4,
              head_dim=8, seq_len=16, batchsize=2, moe_every=1,
              num_experts=4, experts_per_token=2)
    shapes = {"data": {"input": (16,), "target": (16,)}}
    jnet = jbuild_net(jtransformer_lm(**kw), "kTrain", shapes)
    tnet = tbuild_net(ttransformer_lm(**kw), "kTrain", shapes)
    arrays = numpy_params(tnet, seed=1)
    x = np.random.default_rng(2).standard_normal((2, 16, 32)).astype(
        np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    jout = jnet.layers["moe0"].apply(
        {k: jnp.asarray(v) for k, v in arrays.items()}, [jx],
        JContext(batch={}, train=True, compute_dtype=jnp.bfloat16))
    jaux = jnet.layers["moe0"]._aux
    layer = tnet.layers["moe0"]
    tout = layer.apply(params_from_numpy(tnet, arrays, device="cpu"),
                       [torch.from_numpy(x).to(torch.bfloat16)],
                       TContext(batch={}, train=True,
                                compute_dtype=torch.bfloat16))
    assert tout.dtype == torch.bfloat16
    want = np.asarray(jout, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(tout.float().numpy(), want, rtol=0, atol=ulp)
    np.testing.assert_allclose(float(layer._aux), float(jaux), rtol=1e-5)


def test_top_k_ties_keep_the_lowest_index_as_jax():
    """C2: `torch.topk` orders ties its own way (on the CPU the top 2 of
    six zeros are [3, 5]); the port's `top_k` and `topk_precision` give
    `jax.lax.top_k`'s answer."""
    zeros = np.zeros((2, 6), np.float32)
    assert torch.topk(torch.from_numpy(zeros), 2).indices.tolist() != \
        np.asarray(jax.lax.top_k(jnp.asarray(zeros), 2)[1]).tolist()
    rng = np.random.default_rng(0)
    for x in (zeros, np.array([[1, 1, 1, .5]], np.float32),
              rng.integers(0, 3, (16, 9)).astype(np.float32),
              np.full((3, 5), -1e30, np.float32)):
        for k in range(1, x.shape[1] + 1):
            jv, ji = jax.lax.top_k(jnp.asarray(x), k)
            tv, ti = top_k(torch.from_numpy(x), k)
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # a zero-initialised head: every logit ties, so the top 2 are
    # classes 0 and 1, and labels 1 and 3 are one hit of two
    logits, labels = np.zeros((2, 6), np.float32), np.array([1, 3])
    want = float(jtopk_precision(jnp.asarray(logits), jnp.asarray(labels),
                                 topk=2))
    got = float(topk_precision(torch.from_numpy(logits),
                               torch.from_numpy(labels), topk=2))
    assert got == want == 0.5


# ---------------------------------------------------------------------------
# lm.conf


B, S = 2, 128
SHAPES = {"data": {"input": (S,), "target": (S,)}}


def _lm_conf(load):
    """lm.conf with only batch and sequence shrunk (the strided flash
    route still runs: S % 128 == 0), in f32."""
    cfg = load(LM_CONF)
    data = cfg.neuralnet.layer[0]
    assert data.type == "kSequenceData"
    data.seqdata_param.batchsize, data.seqdata_param.seq_len = B, S
    cfg.precision = "float32"
    return cfg


def test_lm_conf_builds_with_its_moe_block():
    tr = Trainer(tload(LM_CONF), {"data": {"input": (512,),
                                           "target": (512,)}},
                 device="cpu")
    net = tr.train_net
    moe = net.layers["moe1"]
    assert (moe.n_exp, moe.k) == (4, 2)
    assert net.param_specs["moe1/w1"].shape == (4, 256, 640)
    assert net.param_specs["moe1/router"].shape == (256, 4)
    assert tr.compute_dtype == torch.bfloat16
    assert net.layers["attn0"].seq_parallel == "ring"
    assert not net.layers["attn0"]._packed_eligible(512)


def test_lm_conf_adam_step_matches_jax_trainer():
    jtr = JTrainer(_lm_conf(jload), SHAPES, log_fn=lambda s: None,
                   donate=False)
    jp, jo = jtr.init(0)
    tr = Trainer(_lm_conf(tload), SHAPES, device="cpu")
    tp = params_from_numpy(tr.train_net, _host(jp), device="cpu")
    to = opt_state_from_numpy(tr.train_net, _host(jo), device="cpu")
    batch = next(synthetic_token_batches(B, S, 4096, seed=4))
    jp, jo, jm = jtr.train_step(
        jp, jo, jax.tree_util.tree_map(jnp.asarray, batch), 0,
        jax.random.PRNGKey(0))
    tp, to, tm = tr.train_step(tp, to, batch, 0)
    assert set(tm) == set(jm) == {"loss", "precision", "moe1/aux"}
    for k in ("loss", "moe1/aux"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    assert float(tm["precision"]) == float(jm["precision"])
    got_p, _ = state_to_numpy(tp, to)
    gaps = np.concatenate([np.abs(got_p[k] - np.asarray(jp[k])).ravel()
                           for k in sorted(got_p)])
    assert gaps.max() <= 1e-4 and np.mean(gaps > 1e-6) <= 1e-3, \
        (gaps.max(), int(np.sum(gaps > 1e-6)))


TINY = dict(vocab_size=64, num_layers=2, embed_dim=32, num_heads=4,
            head_dim=8, seq_len=16, batchsize=2, moe_every=2,
            num_experts=4, experts_per_token=2)
TINY_SHAPES = {"data": {"input": (16,), "target": (16,)}}


def test_aux_loss_flows_through_every_trainer_path():
    """`moe1/aux` joins the objective and is reported by train_step,
    train_steps (stacked, deferred), run's hooks and the eval step."""
    cfg = ttransformer_lm(**TINY)
    cfg.test_steps, cfg.train_steps, cfg.display_frequency = 1, 2, 0
    tr = Trainer(cfg, TINY_SHAPES, device="cpu")
    data = synthetic_token_batches(2, 16, 64, seed=6)
    batches = [next(data) for _ in range(2)]
    p, o = tr.init(1)
    loss, metrics, _ = tr.train_net.apply(p, batches[0], train=True)
    assert float(loss) == float(metrics["loss"] + metrics["moe1/aux"])
    assert 0 < float(metrics["moe1/aux"]) < 1
    pa, oa, stacked = tr.train_steps(
        p, o, {"data": {f: np.stack([b["data"][f] for b in batches])
                        for f in ("input", "target")}}, 0, 2, stacked=True)
    pb, ob = tr.init(1)
    for step, batch in enumerate(batches):
        pb, ob, m = tr.train_step(pb, ob, batch, step)
        assert torch.equal(stacked["moe1/aux"][step], m["moe1/aux"])
    seen = []
    tr.run(*tr.init(1), iter(batches), hooks=[lambda s, m: seen.append(m)],
           scan_chunk=2)
    assert [m["moe1/aux"] for m in seen] == \
        [float(v) for v in stacked["moe1/aux"]]
    avg = tr.evaluate(pa, iter(batches), 1, tr.test_step)
    assert set(avg) == {"loss", "precision", "moe1/aux"}


def test_moe_checkpoints_cross_between_packages(tmp_path, monkeypatch):
    """A MoE net's params and Adam state: port npz → JAX, JAX npz →
    port, and through `params_from_numpy`/`state_to_numpy`."""
    monkeypatch.setattr(jckpt, "_HAVE_ORBAX", False)
    tr = Trainer(ttransformer_lm(**TINY), TINY_SHAPES, device="cpu")
    jtr = JTrainer(jtransformer_lm(**TINY), TINY_SHAPES,
                   log_fn=lambda s: None, donate=False)
    tp, to = tr.init(2)
    data = synthetic_token_batches(2, 16, 64, seed=7)
    tp, to, _ = tr.train_step(tp, to, next(data), 0)
    ws = str(tmp_path)
    tckpt.CheckpointManager(ws).save(1, tp, to)
    rp, ro, step = jckpt.CheckpointManager(ws, log_fn=lambda s: None) \
        .restore()
    want_p, want_o = state_to_numpy(tp, to)
    assert step == 1 and {k for k in rp if k.startswith("moe1/")} == \
        {f"moe1/{n}" for n in PARAMS}
    for k in want_p:
        np.testing.assert_array_equal(np.asarray(rp[k]), want_p[k])
        for slot in ("history", "update"):
            np.testing.assert_array_equal(np.asarray(ro[slot][k]),
                                          want_o[slot][k])
    jp, jo = jtr.init(3)
    jckpt.CheckpointManager(ws, log_fn=lambda s: None).save(
        2, _host(jp), _host(jo))
    p2, o2, step = tr.resume(tp, to, ws)
    assert step == 2
    for k in jp:
        np.testing.assert_array_equal(p2[k].numpy(), np.asarray(jp[k]))
        for slot in ("history", "update"):
            np.testing.assert_array_equal(o2[slot][k].numpy(),
                                          np.asarray(jo[slot][k]))
    with pytest.raises(ValueError, match="moe1/w1"):
        bad = dict(_host(jp))
        bad["moe1/w1"] = bad["moe1/w1"][:, :, :3]
        params_from_numpy(tr.train_net, bad, device="cpu")
