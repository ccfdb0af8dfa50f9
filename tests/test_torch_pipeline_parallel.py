"""Pipeline parallelism in the port, on the CPU: `singa_tpu_torch/
parallel/pipeline.py` and `parallel/pipeline_net.py` against the JAX
package's.  The stage assignment and every refusal of the JAX package;
train steps of `transformer_lm(pipeline_stages=...)` with tied
embeddings on pipe=2 (S=128, so the JAX stages take the interpreted
Pallas flash route), data=2 x pipe=2 and the circular schedule (4
stages on pipe=2) over 2- and 4-process gloo groups, against the JAX
`PipelineNet` step on a CPU mesh of the same shape and the JAX
unpipelined step; a heterogeneous conv net (the port's copy of
`tests/test_pipeline.py:149-181`) against the JAX `HeteroPipelineNet`;
3 heterogeneous stages with dropout on pipe=3; and a pipelined
checkpoint that one process resumes.

Tolerances, each with its reason (the JAX package's own,
`tests/test_pipeline.py:58-62`): losses within 1e-5 relative and params
within rtol 2e-4, atol 2e-5 (the same f32 step with its sums in
another order; Adam's first update is ~lr·sign(g), so a gradient near
zero shows its rounding at ~lr); the ranks' gathered params equal bit
for bit (every collective hands each rank the same bits).  Dropout is
held by its properties (masks differ across microbatches and seeds, a
seed reproduces its step): the port does not reproduce Threefry.
"""

import os
import socket
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.config.schema import model_config_from_dict as jconfig
from singa_tpu.core.net import build_net as jbuild_net
from singa_tpu.core.trainer import Trainer as JTrainer
from singa_tpu.models.transformer import transformer_lm as jtransformer_lm
from singa_tpu.parallel import make_mesh as jmake_mesh
from singa_tpu.parallel import pipeline_apply as jpipeline_apply
from singa_tpu.parallel import pipeline_net as jpn
from singa_tpu.parallel import stack_stage_params as jstack

from singa_tpu_torch.config.schema import model_config_from_dict as tconfig
from singa_tpu_torch.core.net import build_net
from singa_tpu_torch.core.trainer import Trainer
from singa_tpu_torch.models.transformer import (synthetic_token_batches,
                                                transformer_lm)
from singa_tpu_torch.ops.dropout import dropout
from singa_tpu_torch.parallel import pipeline as tpipe
from singa_tpu_torch.parallel import pipeline_net as tpn
from singa_tpu_torch.parallel.comm import AxisGroup
from singa_tpu_torch.utils.checkpoint import CheckpointManager
from singa_tpu_torch.weights import params_from_numpy

pytestmark = pytest.mark.port
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_VARS = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")
LM = dict(vocab_size=64, num_layers=2, embed_dim=32, num_heads=2,
          head_dim=16, seq_len=128, batchsize=8)
CIRC = dict(LM, num_layers=4, seq_len=32)
MNIST = {"data": {"pixel": (28, 28), "label": ()}}


def _seq(kw):
    return {"data": {"input": (kw["seq_len"],), "target": (kw["seq_len"],)}}


def _lenet_staged(staged=True):
    """tests/test_pipeline.py's conv net cut into structurally DIFFERENT
    stages: stage 1 conv+pool, stage 2 fc+relu; its weights drawn by
    kUniformSqrtFanIn here (the copy there keeps the all-ones default,
    whose logits of ~1e8 leave nothing to compare across packages)."""
    fan_in = {"init_method": "kUniformSqrtFanIn"}
    mark = (lambda s: {"locationid": s}) if staged else (lambda s: {})
    layers = [
        {"name": "data", "type": "kShardData",
         "data_param": {"batchsize": 16}},
        {"name": "mnist", "type": "kMnistImage", "srclayers": "data"},
        {"name": "label", "type": "kLabel", "srclayers": "data"},
        {"name": "conv1", "type": "kConvolution", "srclayers": "mnist",
         "convolution_param": {"num_filters": 8, "kernel": 5},
         "param": [{"name": "cw", **fan_in}, {"name": "cb"}], **mark(1)},
        {"name": "pool1", "type": "kPooling", "srclayers": "conv1",
         "pooling_param": {"pool": "MAX", "kernel": 2, "stride": 2},
         **mark(1)},
        {"name": "ip1", "type": "kInnerProduct", "srclayers": "pool1",
         "inner_product_param": {"num_output": 32},
         "param": [{"name": "w1", **fan_in}, {"name": "b1"}], **mark(2)},
        {"name": "relu1", "type": "kReLU", "srclayers": "ip1", **mark(2)},
        {"name": "ip2", "type": "kInnerProduct", "srclayers": "relu1",
         "inner_product_param": {"num_output": 10},
         "param": [{"name": "w2", **fan_in}, {"name": "b2"}]},
        {"name": "loss", "type": "kSoftmaxLoss",
         "srclayers": ["ip2", "label"]},
    ]
    return {"name": "lenet-staged", "train_steps": 4,
            "updater": {"type": "kSGD", "base_learning_rate": 0.05,
                        "learning_rate_change_method": "kFixed"},
            "neuralnet": {"layer": layers}}


def _hetero3():
    """tests/test_pipeline.py's 3 heterogeneous stages, one with dropout."""
    layers = [
        {"name": "data", "type": "kShardData",
         "data_param": {"batchsize": 12}},
        {"name": "mnist", "type": "kMnistImage", "srclayers": "data"},
        {"name": "label", "type": "kLabel", "srclayers": "data"},
        {"name": "ip1", "type": "kInnerProduct", "srclayers": "mnist",
         "inner_product_param": {"num_output": 24},
         "param": [{"name": "w1", "init_method": "kUniformSqrtFanIn"},
                   {"name": "b1"}], "locationid": 1},
        {"name": "tanh1", "type": "kTanh", "srclayers": "ip1",
         "locationid": 2},
        {"name": "drop1", "type": "kDropout", "srclayers": "tanh1",
         "dropout_param": {"dropout_ratio": 0.4}, "locationid": 2},
        {"name": "ip2", "type": "kInnerProduct", "srclayers": "drop1",
         "inner_product_param": {"num_output": 10},
         "param": [{"name": "w2", "init_method": "kUniformSqrtFanIn"},
                   {"name": "b2"}], "locationid": 3},
        {"name": "loss", "type": "kSoftmaxLoss",
         "srclayers": ["ip2", "label"]},
    ]
    return {"name": "hetero3", "train_steps": 2,
            "updater": {"type": "kSGD", "base_learning_rate": 0.05,
                        "learning_rate_change_method": "kFixed"},
            "neuralnet": {"layer": layers}}


# -- stage assignment and refusals ---------------------------------------

@pytest.mark.parametrize("which", ["lm4", "lenet"])
def test_stage_assignment_matches_jax(which):
    if which == "lm4":
        kw = dict(CIRC, pipeline_stages=4)
        net = build_net(transformer_lm(**kw), "kTrain", _seq(kw))
        jnet = jbuild_net(jtransformer_lm(**kw), "kTrain", _seq(kw))
    else:
        net = build_net(tconfig(_lenet_staged()), "kTrain", MNIST)
        jnet = jbuild_net(jconfig(_lenet_staged()), "kTrain", MNIST)
    got, want = tpn.stage_assignment(net), jpn.stage_assignment(jnet)
    assert got == want
    pre, stages, post = got
    assert "data" in pre and post[-1] == "loss"
    if which == "lm4":
        assert len(stages) == 4 and all(len(s) == 6 for s in stages)
        # the uniform form accepts it, the conv net takes the hetero form
        tpn.PipelineNet(net, 4)
        jpn.PipelineNet(jnet, 4)
    else:
        for mod, n in ((tpn, net), (jpn, jnet)):
            with pytest.raises(mod.NonUniformStages):
                mod.PipelineNet(n, 4)
            assert mod.HeteroPipelineNet(n, 4).forwarded == ["pool1",
                                                             "relu1"]


def _stub_par(pipe=2):
    """A DataParallel's face as the pipeline's checks see it on pipe rank
    0 of `pipe`, before any collective."""
    one = AxisGroup((0,), 0)
    return SimpleNamespace(pipe=AxisGroup(tuple(range(pipe)), 0), n=1,
                           view=lambda: None, seq_group=one,
                           seq_sharding=False, expert=one, grads=one)


def _corrupt(cfg, name, loc):
    for layer in cfg.neuralnet.layer:
        if layer.name == name:
            layer.locationid = loc
    return cfg


@pytest.mark.parametrize("case", ["mid_zero", "gap", "divide", "hetero_v",
                                  "batch", "micro", "circular", "dtype"])
def test_refusals_match_jax(case):
    """Each refusal of the JAX package, by the port too (kMoE in a
    stage, the port's own, in `test_kmoe_in_a_stage_is_refused`)."""
    kw = dict(CIRC, pipeline_stages=2, batchsize=16)
    if case in ("mid_zero", "gap"):
        edit = (("ffn1", 0) if case == "mid_zero" else ("res3b", 4))
        nets = [build_net(_corrupt(transformer_lm(**kw), *edit), "kTrain",
                          _seq(kw)),
                jbuild_net(_corrupt(jtransformer_lm(**kw), *edit), "kTrain",
                           _seq(kw))]
        match = "locationid 0" if case == "mid_zero" else "contiguous"
        for mod, net in zip((tpn, jpn), nets):
            with pytest.raises(mod.PipelineError, match=match):
                mod.PipelineNet(net, 4)
    elif case in ("divide", "hetero_v"):
        if case == "divide":
            kw = dict(kw, pipeline_stages=4)
            make = (tpn.PipelineNet, jpn.PipelineNet)
            nets = (build_net(transformer_lm(**kw), "kTrain", _seq(kw)),
                    jbuild_net(jtransformer_lm(**kw), "kTrain", _seq(kw)))
            pipe, match = 3, "divides them"
        else:
            make = (tpn.HeteroPipelineNet, jpn.HeteroPipelineNet)
            nets = (build_net(tconfig(_lenet_staged()), "kTrain", MNIST),
                    jbuild_net(jconfig(_lenet_staged()), "kTrain", MNIST))
            pipe, match = 1, "interleaved"
        with pytest.raises(tpn.PipelineError, match=match):
            tpn._check_mesh(make[0](nets[0], 4), _stub_par(pipe))
        with pytest.raises(jpn.PipelineError, match=match):
            jpn._check_mesh(make[1](nets[1], 4),
                            jmake_mesh(jax.devices()[:pipe * 2], pipe=pipe),
                            "pipe")
    elif case == "batch":
        net = build_net(transformer_lm(**kw), "kTrain", _seq(kw))
        jnet = jbuild_net(jtransformer_lm(**kw), "kTrain", _seq(kw))
        batch = next(synthetic_token_batches(16, kw["seq_len"], 64, seed=5))
        with pytest.raises(tpn.PipelineError, match="divisible"):
            tpn.PipelineNet(net, 3).apply(
                net.init_params(0, device="cpu"), batch, par=_stub_par())
        with pytest.raises(jpn.PipelineError, match="divisible"):
            jpn.PipelineNet(jnet, 3).apply(
                jnet.init_params(jax.random.PRNGKey(0)), batch,
                mesh=jmake_mesh(jax.devices()[:2], pipe=2))
    elif case in ("micro", "circular"):
        p, v, n = (4, 1, 2) if case == "micro" else (4, 2, 6)
        match = "to fill" if case == "micro" else "rounds"
        x = np.zeros((n, 2, 4), np.float32)
        with pytest.raises(ValueError, match=match):
            tpipe.pipeline_apply(AxisGroup(tuple(range(p)), 0),
                                 lambda prm, h: h,
                                 [{"w": torch.eye(4)}] * v,
                                 torch.from_numpy(x), virtual=v)
        with pytest.raises(ValueError, match=match):
            jpipeline_apply(jmake_mesh(pipe=p, data=2), lambda prm, h: h,
                            jstack([{"w": jnp.eye(4)}] * (p * v)),
                            jnp.asarray(x), virtual=v)
    else:
        # a hop in another dtype than the staged input is refused before
        # anything travels (the JAX hetero form's message, `:298-307`)
        x = torch.zeros((2, 2, 4))
        with pytest.raises(ValueError, match="produces torch.float64"):
            tpipe.pipeline_apply_hetero(
                AxisGroup((0, 1), 0), lambda s, prm, h, key: h.double(),
                {}, x, [(2, 4), (2, 4)], (2, 4))


def test_kmoe_in_a_stage_is_refused():
    kw = dict(CIRC, pipeline_stages=2, moe_every=2, num_experts=4)
    net = build_net(transformer_lm(**kw), "kTrain", _seq(kw))
    with pytest.raises(tpn.PipelineError, match="kMoE layer 'moe1'"):
        tpn.PipelineNet(net, 4)


def test_cells_draw_apart_and_reproduce():
    """Every (stage, microbatch) cell draws from its own seed: dropout on
    equal microbatches gives different masks, and a rerun the same."""
    x = torch.ones((4, 8, 16))

    def stage(prm, h, key):
        g = torch.Generator().manual_seed(key)
        return dropout(h * prm["s"], 0.5, g)
    run = [tpipe.pipeline_apply(AxisGroup((0,), 0), stage,
                                [{"s": torch.ones(())}] * 2, x, rng=7)
           for _ in range(2)]
    assert torch.equal(run[0], run[1])
    masks = [(run[0][m] != 0) for m in range(4)]
    assert all(not torch.equal(masks[0], m) for m in masks[1:])
    keys = {tpipe.cell_key(7, tpipe.Cell(0, m, s, False, False))
            for s in range(3) for m in range(4)}
    assert len(keys) == 12
    # the stacked layout of the JAX package's stage params
    per = [{"w": np.full((2, 3), s, np.float32)} for s in range(3)]
    np.testing.assert_array_equal(
        tpipe.stack_stage_params([{"w": torch.from_numpy(p["w"])}
                                  for p in per])["w"].numpy(),
        np.asarray(jstack([{"w": jnp.asarray(p["w"])} for p in per])["w"]))


def test_schedule_table_pairs_every_hop():
    """Every cell's output is received exactly when its consumer runs,
    for GPipe and the circular schedule: the flags of `comm.shift`."""
    for p, v, n in ((2, 1, 4), (4, 1, 4), (2, 2, 4), (4, 2, 8), (3, 1, 3)):
        seen = {}
        for d in range(p):
            for t in range(tpipe.ticks(p, v, n)):
                c = tpipe.cell(d, t, p, v, n)
                if c is not None:
                    assert (c.sigma, c.m) not in seen
                    seen[(c.sigma, c.m)] = (d, t)
                    nxt = tpipe.cell((d + 1) % p, t + 1, p, v, n)
                    if not c.final:
                        assert nxt is not None and not nxt.fresh
                        assert (nxt.sigma, nxt.m) == (c.sigma + 1, c.m)
        assert len(seen) == p * v * n


# -- steps over processes ------------------------------------------------

CHILD = textwrap.dedent('''
    import json, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    mode, pid, hostfile, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], \\
        sys.argv[4]
    axes, spec = json.loads(sys.argv[5]), json.loads(sys.argv[6])
    from singa_tpu_torch.config.schema import model_config_from_dict
    from singa_tpu_torch.core.trainer import Trainer
    from singa_tpu_torch.models.transformer import transformer_lm
    from singa_tpu_torch.parallel import comm
    from singa_tpu_torch.parallel.bootstrap import distributed_init
    from singa_tpu_torch.parallel.mesh import make_mesh
    from singa_tpu_torch.parallel.partition import DataParallel
    from singa_tpu_torch.weights import params_from_numpy
    assert distributed_init(pid, hostfile)
    dp = DataParallel(make_mesh(**axes))
    if "lm" in spec:
        cfg = transformer_lm(**spec["lm"])
        s = spec["lm"]["seq_len"]
        shapes = {"data": {"input": (s,), "target": (s,)}}
        fields = ("input", "target")
    else:
        cfg = model_config_from_dict(spec["conf"])
        shapes = {"data": {"pixel": (28, 28), "label": ()}}
        fields = ("pixel", "label")
    tr = Trainer(cfg, shapes, device="cpu", log_fn=lambda s: None, dp=dp,
                 seed=spec.get("seed", 0))
    init = dict(np.load(f"{out}/init.npz"))
    p = dp.shard_params(params_from_numpy(tr.train_net, init, device="cpu"))
    o = tr.updater.init(p)
    data = np.load(f"{out}/batches.npz")
    batches = [{"data": {f: torch.tensor(data[f"{f}{i}"]) for f in fields}}
               for i in range(len(data.files) // len(fields))]
    local = {k: tuple(v.shape) for k, v in p.items()}
    if mode == "ckpt":
        cfg.checkpoint_frequency = 2
        p, o, _ = tr.run(p, o, iter(batches), workspace=f"{out}/ws")
        whole = dp.gather_params(p)
        np.savez(f"{out}/ckpt_{pid}.npz",
                 **{k: v.numpy() for k, v in whole.items()})
        sys.exit(0)
    comm.reset_stats()
    losses = []
    for step, b in enumerate(batches):
        if mode == "twice":   # the same step from the same state again
            q = {k: v.clone() for k, v in p.items()}
            r = {s: {k: v.clone() for k, v in t.items()} for s, t in o.items()}
            _, _, m2 = tr.train_step(q, r, b, step)
            losses.append(float(m2["loss"]))
        p, o, m = tr.train_step(p, o, b, step)
        losses.append(float(m["loss"]))
    shift = comm.stats(dp.pipe, "shift")
    whole = dp.gather_params(p)
    evals = [float(tr._net_apply(tr.train_net)(
        p, dp.shard(batches[0], rows=False), train=False, par=dp)[1]["loss"])]
    np.savez(f"{out}/{mode}_{pid}.npz", losses=np.asarray(losses),
             evals=np.asarray(evals), shift_calls=shift["calls"],
             digest=dp.agree(p), local=json.dumps(local),
             pipe=json.dumps(type(tr._pipeline_nets.get(
                 id(tr.train_net))).__name__),
             **{k: v.numpy() for k, v in whole.items()})
''')


def _hostfile(path, n):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    lines = [f"127.0.0.1:{port}", "localhost", "127.0.0.2", "127.0.0.3"][:n]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _spawn(tmp, mode, axes, spec):
    import json
    n = int(np.prod(list(axes.values())))
    child = tmp / "child.py"
    child.write_text(CHILD)
    hostfile = _hostfile(tmp / f"hostfile_{mode}", n)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for var in ENV_VARS:
        env.pop(var, None)
    procs = [subprocess.Popen(
        [sys.executable, str(child), mode, str(i), hostfile, str(tmp),
         json.dumps(axes), json.dumps(spec)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} exited {p.returncode}:\n{out}"
    return [np.load(tmp / f"{mode}_{i}.npz") for i in range(n)] \
        if mode != "ckpt" else None


def _save_batches(tmp, batches):
    np.savez(tmp / "batches.npz", **{f"{f}{i}": b["data"][f] for i, b in
                                     enumerate(batches)
                                     for f in b["data"]})


def _jax_steps(cfg, shapes, init, batches, mesh=None):
    """The JAX trainer's steps from `init` (on `mesh` when given):
    (losses, params after)."""
    jtr = JTrainer(cfg, shapes, log_fn=lambda s: None, donate=False,
                   mesh=mesh)
    if mesh is not None:
        assert jtr._pipeline_nets, "the JAX pipeline path was not taken"
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    jo = jtr.updater.init(jp)
    losses = []
    for step, b in enumerate(batches):
        jp, jo, m = jtr.train_step(jp, jo, jax.tree_util.tree_map(
            jnp.asarray, b), step, jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    return losses, {k: np.asarray(v) for k, v in jp.items()}


def _held_to(got, losses, params, what):
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5,
                               err_msg=what)
    for k, v in params.items():
        np.testing.assert_allclose(got[k], v, rtol=2e-4, atol=2e-5,
                                   err_msg=f"{what}: {k}")


@pytest.fixture(scope="module")
def lm_case(tmp_path_factory):
    """The S=128 LM's init (the JAX package's own) and batches, and the
    JAX unpipelined steps."""
    tmp = tmp_path_factory.mktemp("lm")
    jtr = JTrainer(jtransformer_lm(**LM), _seq(LM), log_fn=lambda s: None,
                   donate=False)
    init = {k: np.asarray(v) for k, v in jtr.init(0)[0].items()}
    it = synthetic_token_batches(LM["batchsize"], LM["seq_len"],
                                 LM["vocab_size"], seed=5)
    batches = [next(it) for _ in range(2)]
    flat = _jax_steps(jtransformer_lm(**LM), _seq(LM), init, batches)
    return init, batches, flat


@pytest.mark.parametrize("axes", [dict(pipe=2), dict(data=2, pipe=2)],
                         ids=["pipe2", "dp2_pipe2"])
def test_pipelined_lm_steps_match_jax(tmp_path, lm_case, axes):
    """Two Adam steps of a 2-stage LM (tied embedding and head, S=128):
    the port's pipeline equals the JAX PipelineNet on the same mesh
    shape and the JAX unpipelined step; each pipe rank holds its stage's
    params only, the ranks agree, and the pipelined evaluation equals
    the loss of one process's."""
    init, batches, (flat_losses, flat_params) = lm_case
    kw = dict(LM, pipeline_stages=2)
    np.savez(tmp_path / "init.npz", **init)
    _save_batches(tmp_path, batches)
    runs = _spawn(tmp_path, "step", axes, {"lm": kw})
    n = len(runs)
    jmesh = jmake_mesh(jax.devices()[:n], data=axes.get("data", 1),
                       pipe=2)
    piped = _jax_steps(jtransformer_lm(**kw), _seq(kw), init, batches, jmesh)
    assert len({str(r["digest"]) for r in runs}) == 1
    _held_to(runs[0], *piped, "against the JAX PipelineNet")
    _held_to(runs[0], flat_losses, flat_params, "against the JAX flat step")
    import json
    held = [set(json.loads(str(r["local"]))) for r in runs]
    assert "attn0/wq" in held[0] and "attn0/wq" not in held[-1]
    assert "attn1/wq" in held[-1] and "attn1/wq" not in held[0]
    assert all("embed/embedding" in h for h in held)
    assert json.loads(str(runs[0]["pipe"])) == "PipelineNet"
    # 2 steps x 2 ranks' hops (forward and backward) of 4 microbatches
    assert int(runs[0]["shift_calls"]) == 2 * 2 * 4
    one = Trainer(transformer_lm(**LM), _seq(LM), device="cpu",
                  log_fn=lambda s: None)
    whole = params_from_numpy(one.train_net,
                              {k: runs[0][k] for k in init}, device="cpu")
    with torch.no_grad():
        want = one.train_net.apply(whole, batches[0], train=False)[1]["loss"]
    np.testing.assert_allclose(runs[0]["evals"][0], float(want), rtol=1e-5)


def test_circular_schedule_steps_match_jax(tmp_path):
    """4 locationid stages on pipe=2 take the circular schedule (rank d
    holds stages d and d+2) and equal the JAX circular PipelineNet and
    the unpipelined step."""
    kw = dict(CIRC, pipeline_stages=4)
    jtr = JTrainer(jtransformer_lm(**CIRC), _seq(CIRC),
                   log_fn=lambda s: None, donate=False)
    init = {k: np.asarray(v) for k, v in jtr.init(1)[0].items()}
    batches = [next(synthetic_token_batches(8, 32, 64, seed=6))]
    np.savez(tmp_path / "init.npz", **init)
    _save_batches(tmp_path, batches)
    runs = _spawn(tmp_path, "step", dict(pipe=2), {"lm": kw})
    jmesh = jmake_mesh(jax.devices()[:2], pipe=2)
    _held_to(runs[0], *_jax_steps(jtransformer_lm(**kw), _seq(kw), init,
                                  batches, jmesh),
             "against the JAX circular PipelineNet")
    _held_to(runs[0], *_jax_steps(jtransformer_lm(**CIRC), _seq(CIRC), init,
                                  batches), "against the JAX flat step")
    import json
    held = json.loads(str(runs[0]["local"]))
    assert "attn0/wq" in held and "attn2/wq" in held
    assert "attn1/wq" not in held and "attn3/wq" not in held


def test_hetero_conv_net_matches_jax(tmp_path):
    """The conv net cut into a conv stage and an fc stage, on data=2 x
    pipe=2, against the JAX HeteroPipelineNet on the same mesh shape and
    the unpipelined step."""
    jtr = JTrainer(jconfig(_lenet_staged(False)), MNIST,
                   log_fn=lambda s: None, donate=False)
    init = {k: np.asarray(v) for k, v in jtr.init(0)[0].items()}
    rng = np.random.default_rng(7)
    batches = [{"data": {
        "pixel": rng.random((16, 28, 28), np.float32),
        "label": rng.integers(0, 10, (16,)).astype(np.int32)}}]
    np.savez(tmp_path / "init.npz", **init)
    _save_batches(tmp_path, batches)
    runs = _spawn(tmp_path, "step", dict(data=2, pipe=2),
                  {"conf": _lenet_staged()})
    import json
    assert json.loads(str(runs[0]["pipe"])) == "HeteroPipelineNet"
    # every param whole on every pipe rank
    assert all(len(json.loads(str(r["local"]))) == len(init) for r in runs)
    jmesh = jmake_mesh(jax.devices()[:4], data=2, pipe=2)
    _held_to(runs[0], *_jax_steps(jconfig(_lenet_staged()), MNIST, init,
                                  batches, jmesh),
             "against the JAX HeteroPipelineNet")
    _held_to(runs[0], *_jax_steps(jconfig(_lenet_staged(False)), MNIST,
                                  init, batches), "against the JAX flat step")


def test_three_stages_with_dropout_reproduce(tmp_path):
    """3 heterogeneous stages on pipe=3, dropout in stage 2: the same
    step from the same state and seed gives the same loss (its masks
    redrawn alike), two steps give finite, different losses, and another
    seed another loss."""
    from singa_tpu_torch.weights import numpy_params
    net = build_net(tconfig(_hetero3()), "kTrain", MNIST)
    init = numpy_params(net, seed=0)
    rng = np.random.default_rng(8)
    batches = [{"data": {
        "pixel": rng.integers(0, 256, (12, 28, 28)).astype(np.float32),
        "label": rng.integers(0, 10, (12,)).astype(np.int32)}}
        for _ in range(2)]
    np.savez(tmp_path / "init.npz", **init)
    _save_batches(tmp_path, batches)
    a = _spawn(tmp_path, "twice", dict(pipe=3), {"conf": _hetero3()})[0]
    la = a["losses"]          # step 0 twice, step 1 twice
    assert np.isfinite(la).all()
    assert la[0] == la[1] and la[2] == la[3] and la[0] != la[2]
    b = _spawn(tmp_path, "twice", dict(pipe=3),
               {"conf": _hetero3(), "seed": 5})[0]
    assert b["losses"][0] != la[0]


def test_pipelined_checkpoint_resumes_on_one_process(tmp_path, lm_case):
    """Saved by rank 0 under pipe=2: whole and spec-shaped, equal to the
    ranks' gathered params; one process resumes it and trains on."""
    init, batches, _ = lm_case
    np.savez(tmp_path / "init.npz", **init)
    _save_batches(tmp_path, batches)
    kw = dict(LM, pipeline_stages=2, train_steps=2)
    _spawn(tmp_path, "ckpt", dict(pipe=2), {"lm": kw})
    ws = str(tmp_path / "ws")
    rp, ro, step = CheckpointManager(ws).restore()
    assert step == 2
    saved = np.load(tmp_path / "ckpt_0.npz")
    tr = Trainer(transformer_lm(**dict(LM, train_steps=3)), _seq(LM),
                 device="cpu", log_fn=lambda s: None)
    for k, spec in tr.train_net.param_specs.items():
        assert rp[k].shape == spec.shape and \
            ro["history"][k].shape == spec.shape, k
        np.testing.assert_array_equal(rp[k], saved[k], err_msg=k)
    p, o, start = tr.resume(*tr.init(0), ws)
    assert start == 2
    p, o, m = tr.train_step(p, o, batches[0], 2)
    assert np.isfinite(float(m["loss"]))
