"""Tensor parallelism in the port, on the CPU: the tensor half of
`singa_tpu_torch/parallel/partition.py` against the JAX package's
(placements, padding, shards), and train steps over 2- and 4-process
gloo groups against the JAX package's single-device `train_step` on the
same params and batches: a model=2 step and a model=2 x seq=2 ring step
of a small dense transformer (2 layers, E=64, 4 heads of 16, S=128,
B=8), and LeNet (`examples/mnist/conv.conf`) on model=4, whose 50
filters and 10-wide classifier do not divide the axis.  Also a
checkpoint saved under model=2 (spec-shaped, restored by one process,
resumed under model=2 again) and the CLI over a `tensor_parallel: 2`
cluster config.  The shipped 2x2x2 mesh of
`examples/transformer/cluster.conf` (8 processes) runs only on the
card, `chip_smoke.py` phase 20d.

Tolerances, each with its reason:
- the transformer steps against JAX: losses within 1e-4 relative and
  params within rtol 2e-3, atol 1e-5, the JAX package's own for its
  sharded step (`tests/test_sequence.py:173-202`: Adam's first updates
  are ~lr·sign(g), so reduction-order noise in the gradients shows at
  ~1e-4 relative);
- LeNet on model=4 against the single-process port step on the same
  batches: 1e-5 (the partial sums come back in another order);
- the pad of an uneven dim: exactly zero, params and Adam state alike;
- the ranks' gathered params: equal under `torch.equal` (every
  collective hands each rank the same bits).
The process groups use hostfiles of distinct lines, as
`tests/test_torch_distributed.py` does.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.config.schema import load_model_config as jload
from singa_tpu.core.net import build_net as jbuild_net
from singa_tpu.core.trainer import Trainer as JTrainer
from singa_tpu.models.transformer import transformer_lm as jtransformer_lm
from singa_tpu.parallel import make_mesh as jmake_mesh
from singa_tpu.parallel import pad_params as jpad_params
from singa_tpu.parallel import param_shardings as jparam_shardings

from singa_tpu_torch.config.schema import load_model_config as tload
from singa_tpu_torch.core.net import build_net
from singa_tpu_torch.core.trainer import Trainer
from singa_tpu_torch.models.transformer import transformer_lm
from singa_tpu_torch.parallel.mesh import make_mesh
from singa_tpu_torch.parallel.partition import (pad_params, param_shardings,
                                                shard_batch, shard_opt_state,
                                                shard_params)
from singa_tpu_torch.utils.checkpoint import CheckpointManager
from singa_tpu_torch.weights import numpy_params, params_from_numpy

pytestmark = pytest.mark.port
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONV = os.path.join(REPO, "examples", "mnist", "conv.conf")
MNIST = {"data": {"pixel": (28, 28), "label": ()}}
S = 128
SEQ = {"data": {"input": (S,), "target": (S,)}}
LM = dict(vocab_size=64, num_layers=2, embed_dim=64, num_heads=4,
          head_dim=16, seq_len=S, batchsize=8)
ENV_VARS = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_sequence import _hostfile  # noqa: E402


# -- placement and padding against the JAX package -------------------------

def _nets(which):
    if which == "lm":
        return (build_net(transformer_lm(**LM), "kTrain", SEQ),
                jbuild_net(jtransformer_lm(**LM), "kTrain", SEQ))
    return (build_net(tload(CONV), "kTrain", MNIST),
            jbuild_net(jload(CONV), "kTrain", MNIST))


@pytest.mark.parametrize("which", ["lm", "conv"])
@pytest.mark.parametrize("model", [2, 4])
def test_placements_match_jax_param_shardings(which, model):
    """Each param's (axis, dim) is the JAX package's PartitionSpec under
    `pad_uneven=True`, and without it an uneven dim replicates in both;
    the default dims themselves equal the JAX layers'."""
    net, jnet = _nets(which)
    assert net.partition_dims() == jnet.partition_dims()
    mesh = make_mesh(list(range(8)), model=model)
    jmesh = jmake_mesh(model=model)
    for pad in (True, False):
        mine = param_shardings(mesh, net, pad_uneven=pad)
        theirs = jparam_shardings(jmesh, jnet, pad_uneven=pad)
        assert set(mine) == set(theirs)
        for k, where in mine.items():
            spec = [None] * len(net.param_specs[k].shape)
            if where is not None:
                spec[where[1]] = where[0]
            want = tuple(theirs[k].spec)
            assert tuple(spec[:len(want)]) == want and \
                not any(spec[len(want):]), (k, where, want)


def test_pad_and_unpad_match_jax_on_uneven_dims():
    """LeNet on model=4: conv2's 50 filters and ip2's 10 outputs pad to
    52 and 12 with zeros, as the JAX package's `pad_params`; both nets'
    `unpad_params` take them back."""
    net, jnet = _nets("conv")
    arrays = numpy_params(net, seed=0)
    padded = pad_params(make_mesh(list(range(8)), model=4), net,
                        params_from_numpy(net, arrays, device="cpu"))
    jpadded = jpad_params(jmake_mesh(model=4), jnet,
                          {k: jnp.asarray(v) for k, v in arrays.items()})
    assert padded["conv2/weight"].shape[0] == 52
    assert padded["ip2/weight"].shape[1] == 12
    for k in arrays:
        np.testing.assert_array_equal(padded[k].numpy(),
                                      np.asarray(jpadded[k]))
    back, jback = net.unpad_params(padded), jnet.unpad_params(jpadded)
    for k in arrays:
        np.testing.assert_array_equal(back[k].numpy(), arrays[k])
        np.testing.assert_array_equal(np.asarray(jback[k]), arrays[k])
    # padded storage is sliced at use: the net runs on it unchanged
    batch = {"data": {"pixel": torch.rand(4, 28, 28),
                      "label": torch.arange(4)}}
    a = net.apply(params_from_numpy(net, arrays, device="cpu"), batch)[0]
    b = net.apply(padded, batch)[0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_shards_join_to_the_padded_params():
    """Rank r's `shard_params` slice is slice r of the padded array along
    its dim; the optimizer slots shard alike; replicated params stay."""
    net, _ = _nets("conv")
    mesh = make_mesh(list(range(8)), model=4)
    params = params_from_numpy(net, numpy_params(net, seed=1), device="cpu")
    padded = pad_params(mesh, net, params)
    where = param_shardings(mesh, net, pad_uneven=True)
    shards = [shard_params(mesh, net, params, r) for r in range(4)]
    opt = shard_opt_state(mesh, net, {"history": params}, 2)
    for k, (axis, dim) in ((k, w) for k, w in where.items() if w):
        assert axis == "model"
        torch.testing.assert_close(torch.cat([s[k] for s in shards], dim),
                                   padded[k], rtol=0, atol=0)
        torch.testing.assert_close(opt["history"][k], shards[2][k],
                                   rtol=0, atol=0)


def test_batches_shard_rows_over_data_and_tokens_over_seq():
    mesh = make_mesh(list(range(8)), data=2, model=2, seq=2)
    batch = {"data": {"input": np.arange(64).reshape(4, 16),
                      "target": np.arange(64).reshape(4, 16),
                      "weight": np.arange(4)}}
    rank = int(mesh.devices[1, 0, 0, 1, 0])     # data 1, seq 1
    got = shard_batch(mesh, batch, rank, seq_axis="seq")
    np.testing.assert_array_equal(got["data"]["input"],
                                  np.arange(64).reshape(4, 16)[2:, 8:])
    np.testing.assert_array_equal(got["data"]["weight"], [2, 3])


# -- steps over processes ----------------------------------------------------

CHILD = textwrap.dedent('''
    import hashlib, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    mode, pid, hostfile, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], \\
        sys.argv[4]
    from singa_tpu_torch.core.trainer import Trainer
    from singa_tpu_torch.weights import params_from_numpy

    def save(name, tree, **extra):
        np.savez(f"{out}/{name}_{pid}.npz",
                 **{k: v.numpy() for k, v in tree.items()}, **extra)

    if mode == "cli":
        from singa_tpu_torch.main import main
        rc = main(sys.argv[5:] + ["-hostfile", hostfile, "-procsID",
                                  str(pid)], device="cpu")
        sys.exit(rc)
    from singa_tpu_torch.parallel.bootstrap import distributed_init
    from singa_tpu_torch.parallel.mesh import make_mesh
    from singa_tpu_torch.parallel.partition import DataParallel
    assert distributed_init(pid, hostfile)
    axes = dict(a.split("=") for a in sys.argv[5].split(","))
    dp = DataParallel(make_mesh(**{k: int(v) for k, v in axes.items()}))
    if mode in ("lm", "ckpt", "resume"):
        from singa_tpu_torch.models.transformer import transformer_lm
        cfg = transformer_lm(**%(LM)r, train_steps=4)
        cfg.test_steps = 1
        # seq_parallel per attention layer, cycling through the list
        routes = sys.argv[6].split(",")
        attns = [l for l in cfg.neuralnet.layer if l.attention_param]
        for i, l in enumerate(attns):
            l.attention_param.seq_parallel = routes[i %% len(routes)]
        shapes = %(SEQ)r
    else:
        from singa_tpu_torch.config.schema import load_model_config
        cfg = load_model_config(sys.argv[6])
        shapes = %(MNIST)r
    tr = Trainer(cfg, shapes, device="cpu", log_fn=lambda s: None, dp=dp)
    init = dict(np.load(f"{out}/init.npz"))
    p = dp.shard_params(params_from_numpy(tr.train_net, init, device="cpu"))
    o = tr.updater.init(p)
    data = np.load(f"{out}/batches.npz")
    nb = len(data.files) // 2
    batches = [{"data": {f: torch.tensor(data[f"{f}{i}"])
                         for f in (("input", "target") if "input0" in data
                                   else ("pixel", "label"))}}
               for i in range(nb)]
    if mode in ("ckpt", "resume"):
        cfg.checkpoint_frequency = 2
        start = 0
        if mode == "resume":
            p, o, start = tr.resume(p, o, f"{out}/ws")
            cfg.train_steps = 6
        p, o, hist = tr.run(p, o, iter(batches[start:]), start_step=start,
                            workspace=f"{out}/ws")
        whole, _ = tr._ckpt_state(p, o)
        save(f"{mode}_params", whole, start=start)
        sys.exit(0)
    losses = []
    for step, b in enumerate(batches):
        p, o, m = tr.train_step(p, o, b, step)
        losses.append(float(m["loss"]))
    whole = dp.gather_params(p)
    digest = hashlib.sha256(b"".join(whole[k].numpy().tobytes()
                                     for k in sorted(whole))).hexdigest()
    # the eval step over the mesh against one process's on whole params
    evals = [tr.evaluate(p, iter(batches[:1]), 1, tr.test_step)["loss"]]
    if mode == "lm":
        one = Trainer(cfg, shapes, device="cpu", log_fn=lambda s: None)
        evals.append(one.evaluate(whole, iter(batches[:1]), 1,
                                  one.test_step)["loss"])
    save("local", p, **{f"opt_{k}": v for k, v in o["history"].items()})
    save("params", whole, losses=np.asarray(losses), digest=digest,
         evals=np.asarray(evals))
''' % {"LM": LM, "SEQ": SEQ, "MNIST": MNIST})


def _spawn(tmp, mode, n, *args, rc=0):
    child = tmp / "child.py"
    child.write_text(CHILD)
    hostfile = _hostfile(tmp / f"hostfile_{mode}", n)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for var in ENV_VARS:
        env.pop(var, None)
    procs = [subprocess.Popen([sys.executable, str(child), mode, str(i),
                               hostfile, str(tmp), *map(str, args)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(n)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == rc, f"process {i} exited {p.returncode}:\n{out}"
    return outs


def _lm_batches(tmp, nsteps=2):
    from singa_tpu_torch.models.transformer import synthetic_token_batches
    it = synthetic_token_batches(LM["batchsize"], S, LM["vocab_size"], seed=3)
    batches = [next(it)["data"] for _ in range(nsteps)]
    np.savez(tmp / "batches.npz", **{f"{f}{i}": b[f] for i, b in
                                     enumerate(batches) for f in b})
    return [{"data": b} for b in batches]


@pytest.fixture(scope="module")
def jax_lm_steps(tmp_path_factory):
    """The JAX package's single-device trainer from its own init over two
    steps: (init as numpy, batches, losses, params after)."""
    tmp = tmp_path_factory.mktemp("jax_lm")
    jtr = JTrainer(jtransformer_lm(**LM), SEQ, log_fn=lambda s: None,
                   donate=False)
    jp, jo = jtr.init(0)
    init = {k: np.asarray(v) for k, v in jp.items()}
    batches = _lm_batches(tmp)
    rng = jax.random.PRNGKey(0)
    losses = []
    for step, b in enumerate(batches):
        jp, jo, m = jtr.train_step(jp, jo, jax.tree_util.tree_map(
            jnp.asarray, b), step, rng)
        losses.append(float(m["loss"]))
    return init, tmp / "batches.npz", losses, \
        {k: np.asarray(v) for k, v in jp.items()}


@pytest.mark.parametrize("axes,seq_parallel,n", [
    ("model=2", "none", 2), ("model=2,seq=2", "ring,none", 4),
    ("data=2,model=2", "ring", 4)],
    ids=["tp2", "tp2_sp2_ring", "dp2_tp2"])
def test_sharded_lm_step_matches_the_jax_single_device_step(
        tmp_path, jax_lm_steps, axes, seq_parallel, n):
    """Under model=2 x seq=2, attn0 runs ring attention and attn1
    (seq_parallel "none") attends over the seq axis's gathered kv.
    Under data=2 x model=2 the gradients are averaged over the data
    ranks and never over the model ranks, whose shards differ; the ring
    layers, with no seq axis, take the strided route."""
    init, batches, losses, want = jax_lm_steps
    np.savez(tmp_path / "init.npz", **init)
    (tmp_path / "batches.npz").write_bytes(batches.read_bytes())
    _spawn(tmp_path, "lm", n, axes, seq_parallel)
    runs = [np.load(tmp_path / f"params_{i}.npz") for i in range(n)]
    assert len({str(r["digest"]) for r in runs}) == 1
    got = runs[0]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-4)
    # evaluation over the mesh (a seq chunk a rank under SP) equals one
    # process's on the same whole params
    np.testing.assert_allclose(got["evals"][0], got["evals"][1], rtol=1e-5)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=2e-3, atol=1e-5,
                                   err_msg=k)
    # a model rank holds half of each sharded param
    local = np.load(tmp_path / "local_0.npz")
    assert local["attn0/wq"].shape == (64, 32)
    assert local["embed/embedding"].shape == (64, 32)
    assert local["ffn0/w2"].shape[0] * 2 == want["ffn0/w2"].shape[0]


def test_uneven_dims_train_on_model_4_with_exactly_zero_pads(tmp_path):
    """LeNet over 4 processes of a model axis: the same params as the
    single-process port after 3 kSGD steps, and the pads of conv2's 50
    filters and ip2's 10 outputs stay exactly zero on the last rank."""
    net = build_net(tload(CONV), "kTrain", MNIST)
    init = numpy_params(net, seed=0)
    np.savez(tmp_path / "init.npz", **init)
    rng = np.random.default_rng(0)
    batches = [{"pixel": rng.random((16, 28, 28), np.float32),
                "label": rng.integers(0, 10, 16).astype(np.int32)}
               for _ in range(3)]
    np.savez(tmp_path / "batches.npz", **{f"{f}{i}": b[f] for i, b in
                                          enumerate(batches) for f in b})
    _spawn(tmp_path, "conv", 4, "model=4", CONV)
    tr = Trainer(tload(CONV), MNIST, device="cpu", log_fn=lambda s: None)
    p = params_from_numpy(tr.train_net, init, device="cpu")
    o = tr.updater.init(p)
    for step, b in enumerate(batches):
        p, o, _ = tr.train_step(p, o, {"data": b}, step)
    got = np.load(tmp_path / "params_0.npz")
    for k, v in p.items():
        np.testing.assert_allclose(got[k], v.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    last = np.load(tmp_path / "local_3.npz")
    assert last["conv2/weight"].shape[0] == 13
    assert last["ip2/weight"].shape[1] == 3
    for name, pad in (("conv2/weight", np.s_[-2:, :]),
                      ("conv2/bias", np.s_[-2:]),
                      ("ip2/weight", np.s_[:, -2:]),
                      ("ip2/bias", np.s_[-2:])):
        assert not last[name][pad].any(), name
        assert not last[f"opt_{name}"][pad].any(), name


def test_checkpoint_under_model_2_is_whole_and_resumes_anywhere(
        tmp_path, jax_lm_steps):
    """Saved by rank 0 under model=2: spec-shaped; one process restores
    it; model=2 resumes it and trains on as one process does from it."""
    init, _, _, _ = jax_lm_steps
    np.savez(tmp_path / "init.npz", **init)
    batches = _lm_batches(tmp_path, 6)
    _spawn(tmp_path, "ckpt", 2, "model=2", "none")
    ws = str(tmp_path / "ws")
    rp, ro, step = CheckpointManager(ws).restore()
    assert step == 4
    tr = Trainer(transformer_lm(**LM, train_steps=6), SEQ, device="cpu",
                 log_fn=lambda s: None)
    for k, spec in tr.train_net.param_specs.items():
        assert rp[k].shape == spec.shape and ro["history"][k].shape == \
            spec.shape, k
    saved = np.load(tmp_path / "ckpt_params_0.npz")
    for k in rp:
        np.testing.assert_array_equal(rp[k], saved[k])
    p, o, start = tr.resume(*tr.init(0), ws)
    assert start == 4
    for step in (4, 5):
        p, o, _ = tr.train_step(p, o, batches[step], step)
    _spawn(tmp_path, "resume", 2, "model=2", "none")
    got = np.load(tmp_path / "resume_params_0.npz")
    assert int(got["start"]) == 4
    for k, v in p.items():
        np.testing.assert_allclose(got[k], v.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert CheckpointManager(ws).latest_step() == 6


def test_cli_trains_a_tensor_parallel_cluster_config(tmp_path):
    """`-cluster_conf` with `tensor_parallel: 2` over a 2-line hostfile:
    both ranks train and agree on the params."""
    cluster = tmp_path / "cluster.conf"
    cluster.write_text("tensor_parallel: 2\n")
    conf = os.path.join(REPO, "examples", "transformer", "lm_tiny.conf")
    outs = _spawn(tmp_path, "cli", 2, "-model_conf", conf, "-cluster_conf",
                  str(cluster), "--synthetic", "--steps", "4")
    digests = set()
    for out in outs:
        assert "'model': 2" in out and "training done" in out, out
        digests.update(line.split("sha256 ")[1].split()[0] for line in
                       out.splitlines() if "ranks agree" in line)
    assert len(digests) == 1
