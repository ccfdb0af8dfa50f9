"""Training over several processes in the port, on the CPU: the
bootstrap (`singa_tpu_torch/parallel/bootstrap.py`), the process mesh
(`parallel/mesh.py`), data parallelism (`parallel/partition.py`, the
trainer's `dp=`, the CLI's `-hostfile`/`-procsID`) and
`DistributedReplicaSet` (`parallel/elastic.py`), in 2-process gloo
groups that the tests spawn, on the in-repo `examples/mnist/*.conf`;
also a signal to one rank, resuming only from one shared state, and the
refusal of nets that compute over the whole batch (kMoE, CD) under a
data axis.  `tests/test_torch_distributed_replicas.py` holds
`DistributedReplicaSet` against the JAX one and over 3 processes.

Tolerances, each with its reason:
- the 2-process data-parallel step against the single-process port step
  on the same global batches: losses within 1e-6 relative and params
  within 1e-6 — the mean of two half-batch means is the full-batch
  mean, summed in another order;
- against the JAX single-device step: 1e-5 (plus 1e-5 relative), as
  `tests/test_torch_vision.py` holds three kSGD steps;
- the ranks' params: equal under `torch.equal` (the gradients' one
  all-reduce hands every rank the same bits);
- `DistributedReplicaSet` against the in-process `ReplicaSet` on the
  same seeds: equal under `torch.equal` — the same chain of the same
  f32 operations on the same CPU, replica for replica, each side on one
  thread (a matmul's sums follow the thread count).
"""

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
import torch

from singa_tpu.config.schema import ClusterConfig as JCluster
from singa_tpu.config.schema import load_model_config as jload
from singa_tpu.core.trainer import Trainer as JTrainer
from singa_tpu.parallel import bootstrap as jboot
from singa_tpu.parallel import mesh as jmesh

import singa_tpu_torch.main as tmain
from singa_tpu_torch.config.schema import ClusterConfig
from singa_tpu_torch.config.schema import load_model_config as tload
from singa_tpu_torch.config.schema import model_config_from_text as tconfig
from singa_tpu_torch.core.layers import Context
from singa_tpu_torch.core.trainer import Trainer
from singa_tpu_torch.data.synthetic import synthetic_image_batches
from singa_tpu_torch.ops.augment import elastic_deform
from singa_tpu_torch.ops.dropout import dropout
from singa_tpu_torch.parallel import bootstrap, elastic as tel
from singa_tpu_torch.parallel.mesh import make_mesh, mesh_from_cluster
from singa_tpu_torch.parallel.partition import shard_batch
from singa_tpu_torch.utils.checkpoint import CheckpointManager
from singa_tpu_torch.utils.faults import FaultSchedule, inject
from singa_tpu_torch.weights import params_from_numpy

from port_fixture import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.port
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONV = os.path.join(REPO, "examples", "mnist", "conv.conf")
MNIST = {"data": {"pixel": (28, 28), "label": ()}}
B = 16          # the global batch of the data-parallel cases
DP_STEPS = 3
ENV_VARS = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_elastic import _mlp_text  # noqa: E402


@pytest.fixture(autouse=True)
def _no_launch_env(monkeypatch):
    for var in ENV_VARS:
        monkeypatch.delenv(var, raising=False)


def _hostfile(path, n=2):
    """n distinct lines on this machine, the first with a free port."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    lines = [f"127.0.0.1:{port}", "localhost", "127.0.0.2"][:n]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


CHILD = textwrap.dedent('''
    import json, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    mode, pid, hostfile, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], \\
        sys.argv[4]
    from singa_tpu_torch.config.schema import load_model_config, \\
        model_config_from_text
    from singa_tpu_torch.core.trainer import Trainer
    from singa_tpu_torch.data.synthetic import synthetic_image_batches
    from singa_tpu_torch.weights import params_from_numpy
    MNIST = {"data": {"pixel": (28, 28), "label": ()}}

    def save(name, tree, **extra):
        np.savez(f"{out}/{name}_{pid}.npz",
                 **{k: v.numpy() for k, v in tree.items()}, **extra)

    if mode == "cli":
        from singa_tpu_torch.main import main
        rc = main(sys.argv[5:] + ["-hostfile", hostfile, "-procsID",
                                  str(pid)], device="cpu")
        print("RC", rc, flush=True)
        sys.exit(rc)
    from singa_tpu_torch.parallel.bootstrap import distributed_init
    assert distributed_init(pid, hostfile)
    if mode == "dp":
        from singa_tpu_torch.parallel.mesh import make_mesh
        from singa_tpu_torch.parallel.partition import DataParallel
        cfg = load_model_config(sys.argv[5])
        tr = Trainer(cfg, MNIST, device="cpu", log_fn=lambda s: None,
                     dp=DataParallel(make_mesh()))
        p = params_from_numpy(tr.train_net, dict(np.load(f"{out}/init.npz")),
                              device="cpu")
        o = tr.updater.init(p)
        data = synthetic_image_batches(%(B)d, (28, 28), seed=2)
        losses = []
        for step in range(%(DP_STEPS)d):
            p, o, m = tr.train_step(p, o, next(data), step)
            losses.append(float(m["loss"]))
        save("dp", p, losses=np.asarray(losses))
    elif mode == "state":
        import os, signal
        from singa_tpu_torch.parallel.mesh import make_mesh
        from singa_tpu_torch.parallel.partition import DataParallel
        from singa_tpu_torch.utils.checkpoint import CheckpointManager
        cfg = load_model_config(sys.argv[5])
        cfg.train_steps, cfg.checkpoint_frequency = 8, 100
        tr = Trainer(cfg, MNIST, device="cpu",
                     log_fn=lambda s: print(s, flush=True),
                     dp=DataParallel(make_mesh()))

        def hook(step, metrics):
            if pid == 1 and step == 2:
                os.kill(os.getpid(), signal.SIGTERM)
        p, o = tr.init(seed=0)
        tr.run(p, o, synthetic_image_batches(%(B)d, (28, 28), seed=2),
               workspace=f"{out}/shared", hooks=[hook], seed=0)
        print("RESUMED", tr.resume(*tr.init(seed=0), f"{out}/shared")[2],
              flush=True)
        if pid == 0:
            CheckpointManager(f"{out}/own_0").save(3, p, o)
        try:
            tr.resume(*tr.init(seed=0), f"{out}/own_{pid}")
        except RuntimeError as e:
            print("REFUSED", e, flush=True)
    else:
        from singa_tpu_torch.parallel.elastic import DistributedReplicaSet
        with open(sys.argv[5]) as f:
            cfg = model_config_from_text(f.read())
        tr = Trainer(cfg, MNIST, device="cpu", log_fn=lambda s: None)
        drs = DistributedReplicaSet(tr, seed=0)
        if len(sys.argv) > 6:       # another init, as numpy
            init = params_from_numpy(tr.train_net, dict(np.load(sys.argv[6])),
                                     device="cpu")
            for k, v in init.items():
                drs.params[k].copy_(v)
        it = synthetic_image_batches(32, seed=11, stream_seed=60 + pid)
        center, hist = drs.run(it, steps=12, seed=0)
        save("center", center)
        save("replica", drs.params,
             losses=np.asarray([h["loss"] for h in hist]))
''' % {"B": B, "DP_STEPS": DP_STEPS})


def _spawn(tmp_path, mode, *args, n=2, rc=0, script=CHILD, env=()):
    """Run `script` in `mode` as n processes of one group, each exiting
    with `rc`; their outputs."""
    child = tmp_path / f"child_{abs(hash(script))}.py"
    child.write_text(script)
    hostfile = _hostfile(tmp_path / f"hostfile_{mode}", n)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", **dict(env))
    for var in ENV_VARS:
        env.pop(var, None)
    procs = [subprocess.Popen(
        [sys.executable, str(child), mode, str(i), hostfile, str(tmp_path),
         *map(str, args)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == rc, f"process {i} exited {p.returncode}:\n{out}"
    return outs


# -- the bootstrap ---------------------------------------------------------

def test_one_line_hostfile_is_one_process_in_both_packages(tmp_path):
    hf = tmp_path / "hostfile"
    hf.write_text("# the coordinator\nlocalhost:7001\n\n")
    assert bootstrap.distributed_init(0, str(hf)) is False
    assert jboot.distributed_init(0, str(hf)) is False
    assert bootstrap.distributed_init() is False
    assert bootstrap.process_count() == 1 and bootstrap.process_index() == 0


@pytest.mark.parametrize("case", ["range", "count_alone", "duplicate",
                                  "empty", "env_range"])
def test_argument_checks_match_the_jax_bootstrap(tmp_path, case,
                                                 monkeypatch):
    hf = tmp_path / "hostfile"
    hf.write_text({"duplicate": "a\nb\na\n", "empty": "# none\n"}.get(
        case, "a:1\nb\n"))
    kw = {"range": dict(procs_id=2, hostfile=str(hf)),
          "count_alone": dict(num_processes=2),
          "duplicate": dict(hostfile=str(hf)),
          "empty": dict(hostfile=str(hf)),
          "env_range": dict(hostfile=str(hf))}[case]
    if case == "env_range":
        monkeypatch.setenv("JAX_PROCESS_ID", "5")
    errors = []
    for init in (bootstrap.distributed_init, jboot.distributed_init):
        with pytest.raises(ValueError) as e:
            init(**kw)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("hosts,port", [(["h0", "h1"], 6723),
                                        (["h0:9000", "h1"], 6723),
                                        (["10.0.0.1"], 7000)])
def test_coordinator_address_matches_jax(hosts, port):
    assert (bootstrap.coordinator_address(hosts, port)
            == jboot.coordinator_address(hosts, port))
    assert bootstrap.DEFAULT_PORT == jboot.DEFAULT_PORT == 6723


def test_environment_overrides_win(monkeypatch):
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    assert bootstrap.distributed_init(num_processes=4) is False


def test_cli_runs_a_one_line_hostfile_as_one_process(tmp_path, capsys):
    hf = tmp_path / "hostfile"
    hf.write_text("localhost\n")
    assert tmain.main(["-model_conf", CONV, "--synthetic", "--steps", "2",
                       "--batchsize", "8", "-hostfile", str(hf),
                       "-procsID", "0"], device="cpu") == 0
    out = capsys.readouterr()
    assert "training done" in out.out + out.err
    assert "process group" not in out.out + out.err


# -- the mesh --------------------------------------------------------------

@pytest.mark.parametrize("fields,ptype,n", [
    ({}, "kNone", 4),
    ({"data_parallel": 2}, "kNone", 2),
    ({"nworkers": 2, "synchronous": True}, "kDataPartition", 2),
    ({"nworkers": 2, "nprocs_per_group": 2}, "kLayerPartition", 4),
    ({"nworkers": 3}, "kNone", 2),          # warns, follows the count
    ({"tensor_parallel": 2, "sequence_parallel": 2}, "kNone", 8),
])
def test_mesh_from_cluster_matches_jax(fields, ptype, n):
    mine = mesh_from_cluster(ClusterConfig(**fields), ptype,
                             devices=list(range(n)))
    theirs = jmesh.mesh_from_cluster(JCluster(**fields), ptype,
                                     devices=jax.devices()[:n])
    assert mine.shape == dict(theirs.shape)
    assert mine.size == n
    assert sorted(mine.devices.reshape(-1)) == list(range(n))


def test_make_mesh_refuses_what_xla_refuses():
    with pytest.raises(ValueError):
        make_mesh(list(range(3)), model=2)
    with pytest.raises(ValueError):
        make_mesh(list(range(4)), data=3)
    assert make_mesh().shape["data"] == 1
    assert make_mesh(list(range(4)), model=2).coords(3) == {
        "data": 1, "model": 1, "pipe": 0, "seq": 0, "expert": 0}


@pytest.mark.parametrize("text", [
    "tensor_parallel: 2", "sequence_parallel: 2", "pipeline_parallel: 2",
    "expert_parallel: 2", "data_parallel: 2\ntensor_parallel: 2\n"
    "sequence_parallel: 2", "kLayerPartition",
    "pipeline_parallel: 2\ntensor_parallel: 2",
    "pipeline_parallel: 2\nexpert_parallel: 2"])
def test_cli_refuses_the_axes_it_lacks(tmp_path, capsys, text):
    """Every axis runs, alone or with others, a pipeline axis together
    with a tensor or expert axis too (the port refuses no cluster config
    that the JAX package runs): on one process a cluster config's mesh
    is not used, as the JAX CLI uses none over one device, and the run
    trains; over as many ranks as it asks for, the port's mesh has the
    JAX package's axes."""
    conf = CONV
    if text == "kLayerPartition":
        conf = str(tmp_path / "conv.conf")
        with open(CONV) as f:
            body = f.read()
        with open(conf, "w") as f:
            f.write(body.replace("neuralnet {",
                                 "neuralnet {\n  partition_type: "
                                 "kLayerPartition", 1))
        text = "nworkers: 1\nnprocs_per_group: 2"
    cluster = tmp_path / "cluster.conf"
    cluster.write_text(text + "\n")
    rc = tmain.main(["-model_conf", conf, "-cluster_conf", str(cluster),
                     "--synthetic", "--steps", "1", "--batchsize", "8"],
                    device="cpu")
    out = capsys.readouterr()
    assert rc == 0 and "training done" in out.out + out.err
    assert "ROADMAP.md" not in out.out + out.err
    fields = {k.strip(): int(v) for k, v in (
        line.split(":") for line in text.splitlines())}
    n = int(np.prod([v for k, v in fields.items()
                     if k.endswith("_parallel")])) \
        if "nworkers" not in fields else 2
    ptype = "kLayerPartition" if "nworkers" in fields else "kNone"
    mine = mesh_from_cluster(ClusterConfig(**fields), ptype,
                             devices=list(range(n)))
    theirs = jmesh.mesh_from_cluster(JCluster(**fields), ptype,
                                     devices=jax.devices()[:n])
    assert mine.shape == dict(theirs.shape)


@pytest.mark.parametrize("axis", ["data_parallel", "sequence_parallel"])
def test_cli_refuses_data_or_seq_over_kmoe(tmp_path, axis):
    """kMoE routes the global batch's tokens (`ops/moe.py`), so lm.conf
    under a data or seq axis of 2 trains over 2 processes, and the
    ranks agree on the params."""
    cluster = tmp_path / "cluster.conf"
    cluster.write_text(f"{axis}: 2\n")
    outs = _spawn(tmp_path, "cli", "-model_conf",
                  os.path.join(REPO, "examples", "transformer", "lm.conf"),
                  "-cluster_conf", str(cluster), "--synthetic", "--steps",
                  "1", "--batchsize", "2")
    digests = set()
    for out in outs:
        assert "training done" in out and "ranks agree" in out, out
        digests.add(re.search(r"params sha256 (\w+)", out).group(1))
    assert len(digests) == 1


# -- data parallelism ------------------------------------------------------

def test_shard_batch_slices_dim_0_and_refuses_a_ragged_batch():
    mesh = make_mesh([0, 1])
    batch = {"data": {"pixel": np.arange(12).reshape(4, 3),
                      "label": torch.arange(4)}}
    got = shard_batch(mesh, batch, 1)
    np.testing.assert_array_equal(got["data"]["pixel"],
                                  np.arange(6, 12).reshape(2, 3))
    assert got["data"]["label"].tolist() == [2, 3]
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(mesh, {"x": np.zeros((3, 2))}, 0)


@pytest.mark.parametrize("op", ["dropout", "elastic"])
def test_a_slice_draws_its_rows_of_the_global_draw(op):
    x = torch.randn(8, 12, 12)

    def run(t, rows):
        gen = torch.Generator().manual_seed(5)
        if op == "dropout":
            return dropout(t, 0.5, gen, rows=rows)
        return elastic_deform(t, gen, kernel=5, sigma=3.0, alpha=2.0,
                              beta=10.0, gamma=5.0, rows=rows)
    whole = run(x, None)
    for i in range(2):
        ctx = Context(batch={}, train=True, shard=(i, 2))
        part = run(x[4 * i:4 * i + 4], ctx.global_rows(4))
        assert torch.equal(part, whole[4 * i:4 * i + 4])


@pytest.fixture(scope="module")
def lenet_init(tmp_path_factory):
    """The JAX LeNet's init (examples/mnist/conv.conf) as numpy."""
    jtr = JTrainer(jload(CONV), MNIST, log_fn=lambda s: None)
    jp = jtr.train_net.init_params(jax.random.PRNGKey(1))
    return {k: np.asarray(v) for k, v in jp.items()}


@pytest.mark.parametrize("distort", [False, True])
def test_data_parallel_step_equals_the_single_process_and_jax_steps(
        tmp_path, lenet_init, distort):
    """conv.conf's LeNet, and a copy that distorts every image (kernel 5,
    sigma 6, alpha 8, beta 15, gamma 15: each rank keeps its rows of the
    global batch's draws), over 2 processes against one; the undistorted
    net against the JAX step too (the JAX package draws other numbers)."""
    conf = CONV
    if distort:
        conf = str(tmp_path / "conv_distort.conf")
        with open(CONV) as f:
            text = f.read()
        with open(conf, "w") as f:
            f.write(text.replace("norm_a: 255.0", "norm_a: 255.0 kernel: 5 "
                                 "sigma: 6.0 alpha: 8.0 beta: 15.0 "
                                 "gamma: 15.0", 1))
    np.savez(tmp_path / "init.npz", **lenet_init)
    _spawn(tmp_path, "dp", conf)
    ranks = [np.load(tmp_path / f"dp_{i}.npz") for i in range(2)]
    for k in lenet_init:
        assert torch.equal(torch.from_numpy(ranks[0][k]),
                           torch.from_numpy(ranks[1][k])), k
    # the port on one process
    tr = Trainer(tload(conf), MNIST, log_fn=lambda s: None, device="cpu")
    assert bool(tr.train_net.drawing_layers()) == distort
    tp = params_from_numpy(tr.train_net, lenet_init, device="cpu")
    to = tr.updater.init(tp)
    # the JAX package on one device
    jtr = JTrainer(jload(CONV), MNIST, log_fn=lambda s: None)
    jp = {k: jnp.asarray(v) for k, v in lenet_init.items()}
    jo = jtr.updater.init(jp)
    data = synthetic_image_batches(B, (28, 28), seed=2)
    tl, jl = [], []
    for step in range(DP_STEPS):
        batch = next(data)
        tp, to, tm = tr.train_step(tp, to, batch, step)
        tl.append(float(tm["loss"]))
        if not distort:
            jp, jo, jm = jtr.train_step(
                jp, jo, jax.tree_util.tree_map(jnp.asarray, batch), step,
                jax.random.PRNGKey(0))
            jl.append(float(jm["loss"]))
    np.testing.assert_allclose(ranks[0]["losses"], tl, rtol=1e-6)
    for k in lenet_init:
        np.testing.assert_allclose(ranks[0][k], tp[k].numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
        if not distort:
            np.testing.assert_allclose(ranks[0][k], np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
    if not distort:
        np.testing.assert_allclose(ranks[0]["losses"], jl, rtol=1e-5)


def _conv_every_step(tmp_path):
    """conv.conf with a display line every step."""
    path = str(tmp_path / "conv.conf")
    with open(CONV) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(re.sub(r"display_frequency: \d+", "display_frequency: 1",
                       text))
    return path


def _losses(text):
    return [float(m) for m in re.findall(r"step-\d+: .*?loss : ([\d.]+)",
                                         text)]


def test_cli_trains_data_parallel_from_the_cluster_config(tmp_path, capsys):
    conf = _conv_every_step(tmp_path)
    cluster = tmp_path / "cluster.conf"
    cluster.write_text("data_parallel: 2\n")
    common = ["-model_conf", conf, "--synthetic", "--steps", "4",
              "--batchsize", str(B)]
    outs = _spawn(tmp_path, "cli", *common, "-cluster_conf", str(cluster),
                  "--workspace", str(tmp_path / "ws2"))
    assert all("RC 0" in o and "mesh: {'data': 2" in o for o in outs)
    digests = [re.search(r"ranks agree: params sha256 (\w+)", o).group(1)
               for o in outs]
    assert digests[0] == digests[1]
    assert tmain.main(common + ["--workspace", str(tmp_path / "ws1")],
                      device="cpu") == 0
    out = capsys.readouterr()
    single = _losses(out.out + out.err)
    assert len(single) == 4
    for o in outs:
        np.testing.assert_allclose(_losses(o), single, rtol=1e-5)
    one = CheckpointManager(str(tmp_path / "ws1")).restore()
    two = CheckpointManager(str(tmp_path / "ws2")).restore()
    assert one[2] == two[2] == 4
    for k in one[0]:
        np.testing.assert_allclose(two[0][k], one[0][k], rtol=0, atol=1e-6,
                                   err_msg=k)


def test_a_signal_to_one_rank_stops_the_group_and_resume_needs_one_state(
        tmp_path):
    """A SIGTERM to rank 1 alone stops both ranks at one step, where rank
    0 writes the snapshot; both resume that step from the shared
    workspace, and a rank that would take up another step (its own
    workspace, without rank 0's snapshot) fails every rank by name."""
    outs = _spawn(tmp_path, "state", CONV)
    stops = [re.findall(r"checkpointing at step (\d+) and stopping", o)
             for o in outs]
    assert "signal 15 received" in outs[1]
    assert "another rank got a signal" in outs[0]
    assert len(stops[0]) == 1 and stops[0] == stops[1], outs
    step = int(stops[0][0])
    assert 2 < step < 8
    assert CheckpointManager(str(tmp_path / "shared")).restore()[2] == step
    for o in outs:
        assert f"RESUMED {step}" in o
        assert "REFUSED data-parallel ranks hold different state" in o
        assert "rank 0 step 3" in o and "rank 1 step 0" in o


def _lm_tiny_moe(tmp_path):
    with open(os.path.join(REPO, "examples", "transformer",
                           "lm_tiny.conf")) as f:
        text = f.read()
    path = tmp_path / "lm_tiny_moe.conf"
    path.write_text(text.replace(
        'type: kFeedForward\n    srclayers: "ln0b"\n    ffn_param { '
        'hidden_dim: 64 }', 'type: kMoE\n    srclayers: "ln0b"\n    '
        'moe_param { num_experts: 4 experts_per_token: 2 expert_hidden: '
        '64 }'))
    assert "kMoE" in path.read_text()
    return str(path)


def test_cli_refuses_data_parallel_moe(tmp_path, capsys):
    """A kMoE layer sizes expert capacity and takes its aux loss over the
    global batch's tokens, which each rank gathers the routing of: under
    data_parallel: 2 the CLI trains on both ranks, and their losses are
    one process's."""
    cluster = tmp_path / "cluster.conf"
    cluster.write_text("data_parallel: 2\n")
    conf = _lm_tiny_moe(tmp_path)
    with open(conf) as f:
        text = f.read()
    with open(conf, "w") as f:
        f.write(re.sub(r"display_frequency: \d+", "display_frequency: 1",
                       text))
    outs = _spawn(tmp_path, "cli", "-model_conf", conf, "-cluster_conf",
                  str(cluster), "--synthetic", "--steps", "2")
    assert tmain.main(["-model_conf", conf, "--synthetic", "--steps", "2"],
                      device="cpu") == 0
    out = capsys.readouterr()
    want = _losses(out.out + out.err)
    assert len(want) == 2
    for o in outs:
        assert "training done" in o and "ranks agree" in o, o
        assert "ROADMAP.md A9" not in o
        np.testing.assert_allclose(_losses(o), want, rtol=1e-5)


@pytest.mark.parametrize("net", ["moe", "cd"])
def test_the_trainer_refuses_a_batch_coupled_net_under_dp(tmp_path, net,
                                                          capsys):
    """No net is refused under a data axis: kMoE routes the global batch,
    and CD-k runs the chain on each rank's rows with its rows of the
    global batch's uniforms, so rbm.conf through the CLI under
    data_parallel: 2 on 2 processes reports one process's recon."""
    conf = (_lm_tiny_moe(tmp_path) if net == "moe"
            else os.path.join(REPO, "examples", "mnist", "rbm.conf"))
    model = tload(conf)
    from singa_tpu_torch.data.discovery import discover_input_shapes
    shapes = discover_input_shapes(model, force_synthetic=True)
    Trainer(model, shapes, log_fn=lambda s: None, device="cpu")
    if net == "moe":
        return
    cluster = tmp_path / "cluster.conf"
    cluster.write_text("data_parallel: 2\n")
    argv = ["-model_conf", conf, "--synthetic", "--steps", "2"]
    outs = _spawn(tmp_path, "cli", *argv, "-cluster_conf", str(cluster))
    assert tmain.main(argv, device="cpu") == 0
    recon = r"cd\[rbm0\]: recon : ([\d.]+)"
    want = [float(x) for x in re.findall(recon, capsys.readouterr().out)]
    assert len(want) == 1
    for out in outs:
        assert "mesh: {'data': 2" in out and "training done" in out, out
        got = [float(x) for x in re.findall(recon, out)]
        # the line prints 6 decimals
        np.testing.assert_allclose(got, want, rtol=0, atol=1.5e-6)


# -- DistributedReplicaSet -------------------------------------------------

@pytest.mark.parametrize("param_type", ["Elastic", "RandomSync"])
def test_distributed_replica_set_matches_the_replica_set(tmp_path,
                                                         param_type):
    text = _mlp_text(param_type)
    conf = tmp_path / "mlp.conf"
    conf.write_text(text)
    _spawn(tmp_path, "drs", conf)
    centers = [np.load(tmp_path / f"center_{i}.npz") for i in range(2)]
    reps = [np.load(tmp_path / f"replica_{i}.npz") for i in range(2)]
    tr = Trainer(tconfig(text), MNIST, log_fn=lambda s: None, device="cpu")
    rs = tel.ReplicaSet(tr, ngroups=2, seed=0)
    iters = [synthetic_image_batches(32, seed=11, stream_seed=60 + g)
             for g in range(2)]
    # one thread (port_fixture), as the children: a matmul's sums
    # follow the threads
    center, hist = rs.run(iters, steps=12, seed=0)
    for k in center:
        assert torch.equal(torch.from_numpy(centers[0][k]),
                           torch.from_numpy(centers[1][k])), k
        assert torch.equal(torch.from_numpy(centers[0][k]), center[k]), k
        for g in range(2):
            assert torch.equal(torch.from_numpy(reps[g][k]),
                               rs.replicas[g]["params"][k]), (g, k)
    for g in range(2):
        assert reps[g]["losses"].tolist() == [h["loss"] for h in hist[g]]


@pytest.mark.parametrize("param_type", ["RandomSync", "Elastic"])
def test_single_process_sync_commits_atomically_and_rejects_poison(
        param_type):
    """`tests/test_health.py:407-440` on the port: a failure mid-exchange
    leaves params, snapshot and center unchanged, and a poisoned
    contribution is rejected, counted, and changes nothing."""
    text = (_mlp_text(param_type)
            .replace("warmup_steps: 4", "warmup_steps: 0")
            .replace("sync_frequency: 2", "sync_frequency: 1"))
    tr = Trainer(tconfig(text), MNIST, log_fn=lambda s: None, device="cpu")
    drs = tel.DistributedReplicaSet(tr, seed=0)
    data = synthetic_image_batches(32, seed=11, stream_seed=60)
    for step in range(2):
        drs.params, drs.opt, _ = tr.train_step(drs.params, drs.opt,
                                               next(data), step)
        assert drs._sync(step)

    def snap():
        trees = [drs.params, drs.center]
        if param_type == "RandomSync":
            trees.append(drs.snapshot)
        return [{k: v.clone() for k, v in t.items()} for t in trees]

    def unchanged(before):
        for b, a in zip(before, snap()):
            for k in b:
                assert torch.equal(a[k], b[k]), k

    drs.params, drs.opt, _ = tr.train_step(drs.params, drs.opt, next(data),
                                           2)
    before = snap()
    exchange = drs._exchange
    drs._exchange = lambda *a, **k: (_ for _ in ()).throw(
        RuntimeError("mid-sync failure"))
    with pytest.raises(RuntimeError, match="mid-sync"):
        drs._sync(2)
    unchanged(before)
    drs._exchange = exchange
    with inject(FaultSchedule.parse("sync.delta@0:nan")):
        assert drs._sync(3) is False
    assert drs.poisoned_rounds == 1
    unchanged(before)
    # a transport failure past its retries skips the round
    with inject(FaultSchedule.parse(
            "sync.elastic@0:error,sync.elastic@1:error,"
            "sync.elastic@2:error")):
        with pytest.raises(tel.SyncRoundSkipped):
            tel.sync_with_retries(lambda: drs._sync(4), attempts=3,
                                  log=lambda s: None, step=4,
                                  backoff=tel.Backoff(base=0.0, cap=0.0))
    unchanged(before)
    assert drs._sync(5)     # and a clean round moves the center
    assert any(not torch.equal(a, before[1][k])
               for k, a in drs.center.items())
