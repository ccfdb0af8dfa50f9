"""A pipe axis beside a model, seq or expert axis, and kMoE inside a
pipeline stage, in the port on the CPU, against the JAX package's
pipelined `Trainer` on a CPU mesh of the same shape.

`transformer_lm(pipeline_stages=2, num_layers=2, embed_dim=32,
seq_len=32, batchsize=16)` (vocabulary 64, 2 heads of 16) trains one
Adam step over 4-process gloo groups: pipe=2 x model=2 and pipe=2 x
seq=2 on the dense net, pipe=2 x expert=2 and data=2 x pipe=2 with
`moe_every=1` (kMoE in both stages, at a capacity factor of 0.5, so
that the rows a cell holds decide which tokens are dropped).  In the
JAX package a stage runs with `mesh=None` on its whole params and only
its rows split over "data"; the pre and post groups run over the whole
mesh.  The port does the same: each stage param is whole on every
model, seq and expert rank and only on its pipe rank, a pre or post
param keeps its model shards.  A stage's kMoE routes the cell's tokens
alone, and its aux loss joins neither the loss nor the metrics, in
both packages (the JAX stage calls `layer.apply` directly).  Also: the
CLI under `pipeline_parallel: 2` x `tensor_parallel: 2`, the two
packages' layer lists for `pipeline_stages` with `moe_every`, and a
pipe axis over a net without stages, which replicates the step (kSGD:
a gradient summed over the pipe axis would step twice as far).

Tolerances, each with its reason: the first step's loss within 1e-5
relative (the same f32 step, its sums in another order); params after
the step within 1e-5 absolute (Adam's first update is lr·sign(g), so a
parameter moves at most 3e-4 and the two packages' roundings of it sit
far below that), the kSGD net's within rtol 2e-4, atol 2e-5
(`tests/test_torch_pipeline_parallel.py`'s); the ranks' gathered
params equal bit for bit; the CLI's printed losses within their 6
decimals.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from singa_tpu.config.schema import model_config_from_dict as jconfig
from singa_tpu.core.trainer import Trainer as JTrainer
from singa_tpu.models.transformer import transformer_lm as jtransformer_lm
from singa_tpu.parallel import make_mesh as jmake_mesh

from singa_tpu_torch.models.transformer import (synthetic_token_batches,
                                                transformer_lm)

from port_fixture import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.port
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_VARS = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")
LM = dict(vocab_size=64, num_layers=2, embed_dim=32, num_heads=2,
          head_dim=16, seq_len=32, batchsize=16, pipeline_stages=2)
MOE = dict(LM, moe_every=1, num_experts=4)
MOE_CF = 0.5    # a capacity factor at which a cell's routing drops tokens
SHAPES = {"data": {"input": (32,), "target": (32,)}}
CASES = {
    "pipe2_model2": (dict(pipe=2, model=2), LM),
    "pipe2_seq2": (dict(pipe=2, seq=2), LM),
    "pipe2_expert2_moe": (dict(pipe=2, expert=2), MOE),
    "data2_pipe2_moe": (dict(data=2, pipe=2), MOE),
}
MNIST = {"data": {"pixel": (28, 28), "label": ()}}

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_pipeline_parallel import _lenet_staged  # noqa: E402

CHILD = textwrap.dedent('''
    import json, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    pid, hostfile, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    runs = json.loads(sys.argv[4])
    from singa_tpu_torch.config.schema import model_config_from_dict
    from singa_tpu_torch.core.trainer import Trainer
    from singa_tpu_torch.models.transformer import transformer_lm
    from singa_tpu_torch.parallel import comm
    from singa_tpu_torch.parallel.bootstrap import distributed_init
    from singa_tpu_torch.parallel.mesh import make_mesh
    from singa_tpu_torch.parallel.partition import DataParallel
    from singa_tpu_torch.weights import params_from_numpy
    assert distributed_init(pid, hostfile)
    for run in runs:
        dp = DataParallel(make_mesh(**run["axes"]))
        if "lm" in run:
            s = run["lm"]["seq_len"]
            cfg = transformer_lm(**run["lm"])
            for layer in cfg.neuralnet.layer:
                if layer.moe_param is not None:
                    layer.moe_param.capacity_factor = run["cf"]
            shapes = {"data": {"input": (s,), "target": (s,)}}
        else:
            cfg = model_config_from_dict(run["conf"])
            shapes = {"data": {"pixel": (28, 28), "label": ()}}
        tr = Trainer(cfg, shapes, device="cpu", log_fn=lambda m: None,
                     dp=dp)
        init = dict(np.load(f"{out}/{run['tag']}_init.npz"))
        p = dp.shard_params(params_from_numpy(tr.train_net, init,
                                              device="cpu"))
        o = tr.updater.init(p)
        data = np.load(f"{out}/{run['tag']}_batch.npz")
        batch = {"data": {f: torch.tensor(data[f]) for f in data.files}}
        local = {k: list(v.shape) for k, v in p.items()}
        comm.reset_stats()
        p, o, m = tr.train_step(p, o, batch, 0)
        moe = [n for n, l in tr.train_net.layers.items()
               if getattr(l, "_aux", "none") != "none"]
        whole = dp.gather_params(p)
        np.savez(f"{out}/{run['tag']}_{pid}.npz", loss=float(m["loss"]),
                 metrics=json.dumps(sorted(m)), digest=dp.agree(p),
                 local=json.dumps(local), seq_sharding=dp.seq_sharding,
                 aux_left=json.dumps([n for n in moe
                                      if tr.train_net.layers[n]._aux
                                      is not None]),
                 shifts=comm.stats(dp.pipe, "shift")["calls"],
                 model_bytes=comm.stats(dp.model)["bytes"],
                 **{k: v.numpy() for k, v in whole.items()})
''')


def _hostfile(path, n):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    lines = [f"127.0.0.1:{port}", "localhost", "127.0.0.2", "127.0.0.3"][:n]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _spawn(tmp, runs, n, argv_of=None):
    """n processes of one group running CHILD over `runs`, or each
    running `argv_of(i, hostfile)`; their outputs."""
    child = tmp / "child.py"
    child.write_text(CHILD)
    hostfile = _hostfile(tmp / "hostfile", n)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for var in ENV_VARS:
        env.pop(var, None)
    argv_of = argv_of or (lambda i, hf: [sys.executable, str(child), str(i),
                                         hf, str(tmp), json.dumps(runs)])
    procs = [subprocess.Popen(
        argv_of(i, hostfile), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} exited {p.returncode}:\n{out}"
    return outs


def _jax_step(kw, init, batch, axes):
    """One step of the JAX pipelined trainer on a CPU mesh of `axes`:
    (loss, metric names, params after)."""
    mesh = jmake_mesh(jax.devices()[:4], **axes)
    cfg = jtransformer_lm(**kw)
    for layer in cfg.neuralnet.layer:
        if layer.moe_param is not None:
            layer.moe_param.capacity_factor = MOE_CF
    jtr = JTrainer(cfg, SHAPES, log_fn=lambda s: None, donate=False,
                   mesh=mesh)
    assert jtr._pipeline_nets, "the JAX pipeline path was not taken"
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    jo = jtr.updater.init(jp)
    jp, jo, m = jtr.train_step(jp, jo, jax.tree_util.tree_map(
        jnp.asarray, batch), 0, jax.random.PRNGKey(0))
    return float(m["loss"]), sorted(m), {k: np.asarray(v)
                                         for k, v in jp.items()}


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """Every case in one 4-process group (one process start for all),
    each from the JAX package's own init and one batch of its own."""
    tmp = tmp_path_factory.mktemp("mixed")
    runs, inputs = [], {}
    for i, (tag, (axes, kw)) in enumerate(sorted(CASES.items())):
        flat = {k: v for k, v in kw.items() if k != "pipeline_stages"}
        jtr = JTrainer(jtransformer_lm(**flat), SHAPES,
                       log_fn=lambda s: None, donate=False)
        init = {k: np.asarray(v) for k, v in jtr.init(i)[0].items()}
        batch = next(synthetic_token_batches(16, 32, 64, seed=20 + i))
        np.savez(tmp / f"{tag}_init.npz", **init)
        np.savez(tmp / f"{tag}_batch.npz", **batch["data"])
        inputs[tag] = (init, batch)
        runs.append(dict(tag=tag, axes=axes, lm=kw, cf=MOE_CF))
    # a net without stages on a pipe axis
    jtr = JTrainer(jconfig(_lenet_staged(False)), MNIST,
                   log_fn=lambda s: None, donate=False)
    init = {k: np.asarray(v) for k, v in jtr.init(0)[0].items()}
    rng = np.random.default_rng(8)
    batch = {"data": {"pixel": rng.random((16, 28, 28), np.float32),
                      "label": rng.integers(0, 10, (16,)).astype(np.int32)}}
    np.savez(tmp / "unstaged_init.npz", **init)
    np.savez(tmp / "unstaged_batch.npz", **batch["data"])
    inputs["unstaged"] = (init, batch)
    runs.append(dict(tag="unstaged", axes=dict(data=2, pipe=2),
                     conf=_lenet_staged(False)))
    _spawn(tmp, runs, 4)
    return {tag: (inputs[tag], [np.load(tmp / f"{tag}_{r}.npz")
                                for r in range(4)])
            for tag in [*CASES, "unstaged"]}


@pytest.mark.parametrize("tag", sorted(CASES))
def test_mixed_pipeline_step_matches_jax(mixed, tag):
    axes, kw = CASES[tag]
    (init, batch), ranks = mixed[tag]
    loss, metrics, want = _jax_step(kw, init, batch, axes)
    assert len({str(r["digest"]) for r in ranks}) == 1
    got = ranks[0]
    np.testing.assert_allclose(float(got["loss"]), loss, rtol=1e-5)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-5, err_msg=k)
    # the JAX pipelined step reports no stage aux loss, nor does the
    # port's, and no stage kMoE keeps its aux tensor past the step
    assert json.loads(str(got["metrics"])) == metrics
    assert not [m for m in metrics if m.endswith("/aux")]
    assert all(json.loads(str(r["aux_left"])) == [] for r in ranks)
    # a stage's params whole on its pipe rank, whatever their model or
    # expert marks; the pre and post groups' sharded over the model axis
    local = [json.loads(str(r["local"])) for r in ranks]
    block = "moe0/w1" if "moe_every" in kw else "ffn0/w1"
    first = [i for i, h in enumerate(local) if "attn0/wq" in h]
    assert len(first) == 2 and all("attn1/wq" not in local[i]
                                   for i in first)
    assert all(local[i][block] == list(init[block].shape) for i in first)
    emb = local[0]["embed/embedding"]
    split = 2 if axes.get("model") else 1
    assert emb[1] * split == init["embed/embedding"].shape[1]
    assert all(not bool(r["seq_sharding"]) for r in ranks)
    # 4 microbatches' hops forward and back on each pipe rank
    assert int(got["shifts"]) == 2 * 4


def test_a_pipe_axis_without_stages_replicates_the_step(mixed):
    """A net with no `locationid` marks on data=2 x pipe=2 runs
    unpipelined and each pipe rank computes the whole step, which the
    JAX package's GSPMD replicates: one kSGD step equals JAX's step on
    one device (the gradient is not summed over the pipe axis: kSGD
    moves by twice as much where it is)."""
    (init, batch), ranks = mixed["unstaged"]
    jtr = JTrainer(jconfig(_lenet_staged(False)), MNIST,
                   log_fn=lambda s: None, donate=False)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    jp, _, m = jtr.train_step(jp, jtr.updater.init(jp), jax.tree_util.tree_map(
        jnp.asarray, batch), 0, jax.random.PRNGKey(0))
    assert len({str(r["digest"]) for r in ranks}) == 1
    np.testing.assert_allclose(float(ranks[0]["loss"]), float(m["loss"]),
                               rtol=1e-5)
    for k, v in jp.items():
        np.testing.assert_allclose(ranks[0][k], np.asarray(v), rtol=2e-4,
                                   atol=2e-5, err_msg=k)


def test_cli_trains_a_pipeline_beside_a_tensor_axis(tmp_path, capsys):
    """A staged config under a cluster config of pipeline_parallel: 2 and
    tensor_parallel: 2 through the CLI on 4 processes: the ranks agree,
    and their losses are the one-process CLI's."""
    import re
    from singa_tpu_torch.config.schema import model_config_to_text
    from singa_tpu_torch.main import main as tmain
    cfg = transformer_lm(**LM)
    cfg.display_frequency = 1
    conf = tmp_path / "lm_staged.conf"
    conf.write_text(model_config_to_text(cfg))
    cluster = tmp_path / "cluster.conf"
    cluster.write_text("pipeline_parallel: 2\ntensor_parallel: 2\n")
    argv = ["-model_conf", str(conf), "--synthetic", "--steps", "2"]
    cli = ("import sys; from singa_tpu_torch.main import main; "
           "sys.exit(main(sys.argv[1:], device='cpu'))")
    outs = _spawn(tmp_path, None, 4, lambda i, hf: [
        sys.executable, "-c", cli, *argv, "-cluster_conf", str(cluster),
        "-hostfile", hf, "-procsID", str(i)])
    assert tmain(argv, device="cpu") == 0
    out = capsys.readouterr()

    def losses(text):
        return [float(x) for x in re.findall(r"step-\d+: .*?loss : ([\d.]+)",
                                             text)]
    want = losses(out.out + out.err)
    assert len(want) == 2
    digests = set()
    for o in outs:
        assert "mesh: {'data': 1, 'model': 2, 'pipe': 2" in o, o
        assert "training done" in o and "pipe shifts:" in o, o
        digests.add(re.search(r"params sha256 (\w+)", o).group(1))
        # the lines print 6 decimals
        np.testing.assert_allclose(losses(o), want, rtol=0, atol=2e-6)
    assert len(digests) == 1


def test_pipelined_moe_builds_the_jax_layer_list():
    """`pipeline_stages` with `moe_every` marks the same layers in both
    packages: names, types and locationids in order."""
    for kw in (MOE, dict(MOE, num_layers=4, moe_every=2)):
        mine = transformer_lm(**kw).neuralnet.layer
        theirs = jtransformer_lm(**kw).neuralnet.layer
        assert [(x.name, x.type, x.locationid, list(x.srclayers))
                for x in mine] == [(x.name, x.type, x.locationid,
                                    list(x.srclayers)) for x in theirs]
    kinds = {x.name: x.locationid for x in
             transformer_lm(**MOE).neuralnet.layer if x.type == "kMoE"}
    assert kinds == {"moe0": 1, "moe1": 2}
