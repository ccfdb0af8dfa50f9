"""Contrastive divergence over a process mesh in the port, on the CPU,
against the JAX package's `run_cd` on its 8-device CPU mesh.

`rbm_mnist(widths=(32, 16), batchsize=16)` trains over 2- and 4-process
gloo groups: under data=2, and under data=2 x model=2 with both kRBMs
partitioned (weight over its hidden dim, hbias with it).  Each rank runs
the chain on its rows of the global batch, with its rows of the global
batch's uniforms: here JAX's own uniforms, which the test feeds to
`cd_grads` (`tests/test_torch_rbm.py` draws them so).  JAX's GSPMD keeps
the whole-batch function, so one process equals it too; the port's own
generator draws at the global shapes and each rank keeps its rows, so
the ranks' run equals one process's without JAX's draws.  Also the CLI
on rbm.conf's shape, cut to 784-32-16, over 2 processes, and its
checkpoint resumed by one process.

Tolerances, each with its reason: after one step, params and momentum
within 1e-6 absolute and the reconstruction error within 1e-6 relative
(the weights are ~0.3; the same f32 products, the gradient summed over
a rank's rows and then averaged over the ranks rather than summed over
all rows at once); after `run_cd`'s 8 steps, 1e-5 of each param's
largest magnitude (its momentum's too) and recon within 1e-5
relative, the tolerance of
`tests/test_torch_rbm.py` (one process of the port is 2.9e-6 from JAX
on rbm1/vbias there: rbm1 trains on rbm0's sigmoids, and momentum
carries each step's rounding); the ranks' gathered params equal bit
for bit; against one process of the port, the 2 ranks' run within
1e-6.
"""

import json
import os
import re
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from singa_tpu.core.trainer import Trainer as JTrainer
from singa_tpu.models import rbm as jrbm
from singa_tpu.parallel import make_mesh as jmake_mesh

from singa_tpu_torch.data.synthetic import synthetic_image_batches
from singa_tpu_torch.main import main as tmain
from singa_tpu_torch.models import rbm
from singa_tpu_torch.utils.checkpoint import CheckpointManager

from port_fixture import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.port
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_VARS = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")
SHAPES = {"data": {"pixel": (28, 28), "label": ()}}
B, STEPS = 16, 8
WIDTHS = (32, 16)


def _cfg(make, partitioned=False, persistent=False):
    """rbm_mnist(widths=(32, 16), batchsize=16, train_steps=8); with
    `partitioned` each kRBM's weight and hbias split their hidden dim
    over the model axis; with `persistent` rbm1 runs PCD."""
    cfg = make(widths=WIDTHS, batchsize=B, train_steps=STEPS)
    cfg.display_frequency = 1
    for layer in cfg.neuralnet.layer:
        if layer.rbm_param is None:
            continue
        layer.rbm_param.persistent = persistent and layer.name == "rbm1"
        if partitioned:
            kind = _param_type(make)
            layer.param = [kind(name="weight", partition_dim=1),
                           kind(name="vbias"),
                           kind(name="hbias", partition_dim=0)]
    return cfg


def _param_type(make):
    if make is jrbm.rbm_mnist:
        from singa_tpu.config.schema import ParamConfig
    else:
        from singa_tpu_torch.config.schema import ParamConfig
    return ParamConfig


def _init():
    """rbm_mnist's params drawn large enough that the chain moves."""
    rng = np.random.default_rng(1)
    sizes = (784,) + WIDTHS
    out = {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        out[f"rbm{i}/weight"] = (0.3 * rng.standard_normal((a, b))).astype(
            np.float32)
        out[f"rbm{i}/vbias"] = np.full((a,), 0.05, np.float32)
        out[f"rbm{i}/hbias"] = np.full((b,), 0.05, np.float32)
    return out


def _jax_uniforms(key, k, b, nvis, nhid):
    """The uniforms JAX's CD-k chain draws from `key`: per Gibbs step the
    hidden units', then the visible units'."""
    out = []
    for sub in jax.random.split(key, k):
        kh, kv = jax.random.split(sub)
        out.append(np.asarray(jax.random.uniform(kh, (b, nhid))))
        out.append(np.asarray(jax.random.uniform(kv, (b, nvis))))
    return out


CHILD = textwrap.dedent('''
    import json, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    pid, hostfile, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    spec = json.loads(sys.argv[4])
    from singa_tpu_torch.config.schema import model_config_from_text
    from singa_tpu_torch.core.trainer import Trainer
    from singa_tpu_torch.models import rbm
    from singa_tpu_torch.parallel.bootstrap import distributed_init
    from singa_tpu_torch.parallel.mesh import make_mesh
    from singa_tpu_torch.parallel.partition import DataParallel
    from singa_tpu_torch.weights import params_from_numpy
    assert distributed_init(pid, hostfile)
    dp = DataParallel(make_mesh(**spec["axes"]))
    with open(f"{out}/rbm.conf") as f:
        cfg = model_config_from_text(f.read())
    shapes = {"data": {"pixel": (28, 28), "label": ()}}
    tr = Trainer(cfg, shapes, device="cpu", log_fn=lambda m: None, dp=dp)
    data = np.load(f"{out}/batches.npz")
    batches = [{"data": {"pixel": torch.tensor(data[f"pixel{i}"]),
                         "label": torch.tensor(data[f"label{i}"])}}
               for i in range(len(data.files) // 2)]
    b = batches[0]["data"]["pixel"].shape[0]
    if spec["jax_draws"]:
        # each rank's rows of the global uniforms JAX draws at each step
        us = np.load(f"{out}/uniforms.npz")
        rows = slice(dp.index * b // dp.n, (dp.index + 1) * b // dp.n)
        real, step = rbm.cd_grads, [0]

        def cd_grads(params, v0, rng, k=1, persistent=None):
            it = iter([us[f"{step[0]}_{j}"][rows] for j in range(2 * k)])
            step[0] += 1
            return real(params, v0, lambda shape: torch.from_numpy(
                np.array(next(it))), k, persistent)
        rbm.cd_grads = cd_grads
    p = dp.shard_params(params_from_numpy(
        tr.train_net, dict(np.load(f"{out}/init.npz")), device="cpu"))
    o = tr.updater.init(p)
    local = {k: list(v.shape) for k, v in p.items()}
    recons = []
    if spec["mode"] == "step":
        p, o, m = tr.cd_step(p, o, batches[0], 0, 0, fresh=True)
        recons.append(float(m["recon"]))
    else:
        p, o, _ = tr.run(p, o, iter(batches),
                         hooks=[lambda s, m: recons.append(m["recon"])])
    whole = dp.gather_params(p)
    hist = dp.gather_params(o["history"])
    chain = tr._chains.get(1)
    np.savez(f"{out}/{spec['tag']}_{pid}.npz", recons=np.asarray(recons),
             digest=dp.agree(p, o), local=json.dumps(local),
             chain_rows=-1 if chain is None else chain.shape[0],
             **{k: v.numpy() for k, v in whole.items()},
             **{f"history/{k}": v.numpy() for k, v in hist.items()})
''')


def _hostfile(path, n):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    lines = [f"127.0.0.1:{port}", "localhost", "127.0.0.2", "127.0.0.3"][:n]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _spawn(tmp, argv_of, n):
    """n processes of one group, process i running argv_of(i, hostfile);
    their outputs."""
    hostfile = _hostfile(tmp / f"hostfile_{n}_{len(os.listdir(tmp))}", n)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for var in ENV_VARS:
        env.pop(var, None)
    procs = [subprocess.Popen(argv_of(i, hostfile), env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
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
    return outs


def _ranks(tmp, spec):
    from singa_tpu_torch.config.schema import model_config_to_text
    n = int(np.prod(list(spec["axes"].values())))
    child = tmp / "child.py"
    child.write_text(CHILD)
    (tmp / "rbm.conf").write_text(model_config_to_text(_cfg(
        rbm.rbm_mnist, spec["partitioned"], spec["persistent"])))
    _spawn(tmp, lambda i, hf: [sys.executable, str(child), str(i), hf,
                               str(tmp), json.dumps(spec)], n)
    return [np.load(tmp / f"{spec['tag']}_{i}.npz") for i in range(n)]


def _jax_run(mode, axes, partitioned, persistent, init, batches):
    """JAX's `run_cd` (or its first step) on a CPU mesh of `axes`: the
    recon of each step, params and momentum after, and the uniforms its
    chains drew, by step."""
    mesh = jmake_mesh(jax.devices()[:int(np.prod(list(axes.values())))],
                      **axes)
    cfg = _cfg(jrbm.rbm_mnist, partitioned, persistent)
    if mode == "step":
        cfg.train_steps = 1
    jtr = JTrainer(cfg, SHAPES, log_fn=lambda s: None, donate=False,
                   mesh=mesh)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    jo = jtr.updater.init(jp)
    recons = []
    jp, jo, _ = jtr.run_cd(jp, jo, iter(jax.tree_util.tree_map(
        jnp.asarray, b) for b in batches),
        hooks=[lambda s, m: recons.append(m["recon"])], seed=0)
    net = jtr.train_net
    names = [n for n in net.topo if getattr(net.layers[n], "is_rbm", False)]
    uniforms = {}
    for step in range(cfg.train_steps):
        layer = net.layers[names[min(step * 2 // cfg.train_steps, 1)]]
        key = jax.random.fold_in(jax.random.PRNGKey(0 ^ 0xCD), step)
        for j, u in enumerate(_jax_uniforms(key, layer.cd_k, B, layer.nvis,
                                            layer.nhid)):
            uniforms[f"{step}_{j}"] = u
    return (np.asarray(recons), {k: np.asarray(v) for k, v in jp.items()},
            {k: np.asarray(v) for k, v in jo["history"].items()}, uniforms)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    it = synthetic_image_batches(B, seed=3, stream_seed=30)
    return _init(), [next(it) for _ in range(STEPS)]


def _held(got, recons, params, history, tol=1e-6, scaled=False):
    """recon within `tol` relative; each param and its momentum within
    `tol` absolute, or with `scaled` of the param's largest magnitude (a
    momentum's error is the param's step's)."""
    np.testing.assert_allclose(got["recons"], recons, rtol=tol)
    for k, v in params.items():
        atol = tol * (float(np.abs(v).max()) if scaled else 1.0)
        np.testing.assert_allclose(got[k], v, rtol=0, atol=atol, err_msg=k)
        np.testing.assert_allclose(got[f"history/{k}"], history[k], rtol=0,
                                   atol=atol, err_msg=f"history {k}")


@pytest.mark.parametrize("mode", ["step", "run"])
@pytest.mark.parametrize("axes", [dict(data=2), dict(data=2, model=2)],
                         ids=["dp2", "dp2_tp2"])
def test_cd_over_the_mesh_matches_jax(tmp_path, data, mode, axes):
    """One CD step of rbm0, or `run_cd` over 8 steps of both RBMs (rbm1
    as PCD), each rank fed its rows of JAX's uniforms, against JAX's
    `run_cd` on the same mesh; under the model axis each rank holds half
    of each RBM's weight and hbias, and the saved params come out
    whole."""
    init, batches = data
    partitioned = "model" in axes
    persistent = mode == "run"
    recons, params, history, uniforms = _jax_run(
        mode, axes, partitioned, persistent, init, batches)
    np.savez(tmp_path / "init.npz", **init)
    np.savez(tmp_path / "batches.npz", **{
        f"{f}{i}": b["data"][f] for i, b in enumerate(batches)
        for f in ("pixel", "label")})
    np.savez(tmp_path / "uniforms.npz", **uniforms)
    ranks = _ranks(tmp_path, dict(tag="cd", axes=axes, mode=mode,
                                  partitioned=partitioned,
                                  persistent=persistent, jax_draws=True))
    assert len({str(r["digest"]) for r in ranks}) == 1
    if mode == "step":
        _held(ranks[0], recons, params, history)
    else:
        _held(ranks[0], recons, params, history, 1e-5, scaled=True)
    local = json.loads(str(ranks[0]["local"]))
    split = 2 if partitioned else 1
    assert local["rbm0/weight"] == [784, 32 // split]
    assert local["rbm0/hbias"] == [32 // split]
    assert local["rbm0/vbias"] == [784]
    if persistent:      # a rank's PCD chain holds its rows only
        assert int(ranks[0]["chain_rows"]) == B // 2


def test_cd_ranks_draw_what_one_process_draws(tmp_path, data):
    """The port's own chain generator under data=2: each rank draws the
    global batch's uniforms and keeps its rows, so the 2 ranks' run_cd
    equals one process's."""
    from singa_tpu_torch.core.trainer import Trainer
    from singa_tpu_torch.weights import params_from_numpy
    import torch
    init, batches = data
    tr = Trainer(_cfg(rbm.rbm_mnist, persistent=True), SHAPES, device="cpu",
                 log_fn=lambda m: None)
    p = params_from_numpy(tr.train_net, init, device="cpu")
    o = tr.updater.init(p)
    recons = []
    # one thread (port_fixture), as the children: a matmul's sums
    # follow the threads
    p, o, _ = tr.run(p, o, iter(batches),
                     hooks=[lambda s, m: recons.append(m["recon"])])
    np.savez(tmp_path / "init.npz", **init)
    np.savez(tmp_path / "batches.npz", **{
        f"{f}{i}": b["data"][f] for i, b in enumerate(batches)
        for f in ("pixel", "label")})
    ranks = _ranks(tmp_path, dict(tag="own", axes=dict(data=2), mode="run",
                                  partitioned=False, persistent=True,
                                  jax_draws=False))
    _held(ranks[0], recons, {k: v.numpy() for k, v in p.items()},
          {k: v.numpy() for k, v in o["history"].items()})


def _recons(text):
    return [float(m) for m in re.findall(r"cd\[rbm\d\]: recon : ([\d.]+)",
                                         text)]


def test_rbm_conf_cli_over_two_processes_and_resumed_by_one(tmp_path,
                                                            capsys):
    """rbm.conf cut to 784-32-16 through the CLI under data_parallel: 2 on
    2 processes: the recon lines are one process's, rank 0's checkpoint
    is whole and spec-shaped, and one process resumes it."""
    with open(os.path.join(REPO, "examples", "mnist", "rbm.conf")) as f:
        text = f.read()
    text = text.replace("num_hidden: 250", "num_hidden: 32").replace(
        "num_hidden: 100", "num_hidden: 16").replace(
        "display_frequency: 100", "display_frequency: 1")
    conf = tmp_path / "rbm.conf"
    conf.write_text(text)
    cluster = tmp_path / "cluster.conf"
    cluster.write_text("data_parallel: 2\n")
    ws = str(tmp_path / "ws")
    argv = ["-model_conf", str(conf), "--synthetic", "--steps", "6",
            "--workspace", ws]
    child = tmp_path / "cli.py"
    child.write_text(textwrap.dedent('''
        import sys
        import torch
        torch.set_num_threads(1)
        from singa_tpu_torch.main import main
        sys.exit(main(sys.argv[1:], device="cpu"))
    '''))
    outs = _spawn(tmp_path, lambda i, hf: [
        sys.executable, str(child), *argv, "-cluster_conf", str(cluster),
        "-hostfile", hf, "-procsID", str(i)], 2)
    assert tmain(["-model_conf", str(conf), "--synthetic", "--steps", "6"],
                 device="cpu") == 0
    want = _recons(capsys.readouterr().out)
    assert len(want) == 6
    for out in outs:
        assert "mesh: {'data': 2" in out and "training done" in out, out
        # the lines print 6 decimals
        np.testing.assert_allclose(_recons(out), want, rtol=0, atol=1.5e-6)
    rp, _, step = CheckpointManager(ws).restore()
    assert step == 6 and rp["rbm0/weight"].shape == (784, 32)
    assert tmain(argv[:4] + ["8", "--workspace", ws, "--resume"],
                 device="cpu") == 0
    out = capsys.readouterr()
    assert "resumed from step 6" in out.out + out.err
    assert CheckpointManager(ws).latest_step() == 8
