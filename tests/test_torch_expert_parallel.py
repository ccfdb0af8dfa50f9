"""Global-token kMoE and the expert axis in the port, on the CPU:
`singa_tpu_torch/ops/moe.py` over the ranks that split a batch and over
an expert axis, against the JAX package's single-device step on the
global batch (XLA sees the whole batch, so the JAX package routes, sizes
the capacity and takes the aux loss over every token of a step).

A small kMoE LM (2 blocks, both kMoE with 4 experts top-2, E=32, S=32,
B=8) at a capacity factor of 0.5, where tokens are dropped, trains one
Adam step under data=2, seq=2 (ring attention) and data=2 x expert=2
over 2- and 4-process gloo groups; the routing alone is held on every
block layout of a rows x cols grid; rank-local routing is shown to drop
another set of assignments; an expert rank holds n_exp / ep experts;
and the data=2 x expert=2 run's checkpoint is whole and resumes on one
process.

Tolerances, each with its reason (the JAX package's own for its
expert-parallel step, `tests/test_sequence.py:227-234`): the loss
within 1e-4 relative and params within rtol 2e-3, atol 1e-5 (Adam's
first update is ~lr·sign(g), so reduction-order noise in a gradient
near zero shows at ~lr); the routing exactly (the same top-k on the
same probabilities, one stable sort).
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
import torch

from singa_tpu.core.trainer import Trainer as JTrainer
from singa_tpu.models.transformer import transformer_lm as jtransformer_lm

from singa_tpu_torch.core.net import build_net
from singa_tpu_torch.models.transformer import (synthetic_token_batches,
                                                transformer_lm)
from singa_tpu_torch.ops import moe
from singa_tpu_torch.parallel import comm
from singa_tpu_torch.parallel.comm import AxisGroup
from singa_tpu_torch.utils.checkpoint import CheckpointManager
from singa_tpu_torch.weights import params_from_numpy

pytestmark = pytest.mark.port
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_VARS = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")
LM = dict(vocab_size=64, num_layers=2, embed_dim=32, num_heads=2,
          head_dim=16, seq_len=32, batchsize=8, moe_every=1, num_experts=4)
SEQ = {"data": {"input": (32,), "target": (32,)}}
CF = 0.5


def _moe_cfg(make, **kw):
    cfg = make(**LM, **kw)
    for layer in cfg.neuralnet.layer:
        if layer.moe_param is not None:
            layer.moe_param.capacity_factor = CF
    return cfg


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The JAX init, one global batch, the JAX single-device step on it,
    and moe0's input on that batch (from the port's forward)."""
    tmp = tmp_path_factory.mktemp("moe")
    jtr = JTrainer(_moe_cfg(jtransformer_lm), SEQ, log_fn=lambda s: None,
                   donate=False)
    jp, jo = jtr.init(0)
    init = {k: np.asarray(v) for k, v in jp.items()}
    batch = next(synthetic_token_batches(8, 32, 64, seed=4))
    jp, jo, m = jtr.train_step(jp, jo, jax.tree_util.tree_map(
        jnp.asarray, batch), 0, jax.random.PRNGKey(0))
    net = build_net(_moe_cfg(transformer_lm), "kTrain", SEQ)
    params = params_from_numpy(net, init, device="cpu")
    with torch.no_grad():
        x = net.apply(params, batch, train=True, rng=0)[2]["ln0b"]
    np.savez(tmp / "init.npz", **init)
    np.savez(tmp / "batch.npz", **batch["data"])
    return dict(tmp=tmp, init=init, batch=batch, loss=float(m["loss"]),
                aux=float(m["moe0/aux"]),
                want={k: np.asarray(v) for k, v in jp.items()},
                x=x, router=params["moe0/router"])


def _kept(x, router, cap):
    """The (token, expert) assignments that routing x keeps."""
    t = x.shape[0] * x.shape[1]
    r = moe.route(x.reshape(t, -1), router, 2, cap)
    flat = (torch.arange(t * 2) // 2)[r.order]
    exp = r.expert.reshape(-1)[r.order]
    keep = r.slot < router.shape[1] * cap
    return {(int(a), int(b)) for a, b in zip(flat[keep], exp[keep])}


def test_rank_local_routing_drops_another_set(case):
    """At this capacity factor the global batch drops assignments, and
    two data ranks routing their own halves alone (capacity from their
    own tokens) would keep another set: what the global routing repairs."""
    x, router = case["x"], case["router"]
    t = x.shape[0] * x.shape[1]
    cap = moe.capacity(t, 2, 4, CF)
    whole = _kept(x, router, cap)
    assert len(whole) < 2 * t
    local = set()
    for half in range(2):
        part = _kept(x[4 * half:4 * half + 4], router,
                     moe.capacity(t // 2, 2, 4, CF))
        local |= {(a + half * t // 2, e) for a, e in part}
    assert local != whole


@pytest.mark.parametrize("rows,cols", [(2, 1), (1, 2), (2, 2), (4, 1)])
def test_global_routing_keeps_what_one_process_keeps(case, monkeypatch,
                                                     rows, cols):
    """Each block of a rows x cols grid keeps, by `global_routing`, the
    assignments the single-process ranking keeps, and counts the global
    first choices; the gather is fed every block's ids, as gloo would."""
    x, router = case["x"], case["router"]
    b, s = x.shape[:2]
    probs = torch.softmax(x.reshape(b * s, -1) @ router, dim=-1)
    gate, expert = moe.top_k(probs, 2)
    cap = moe.capacity(b * s, 2, 4, CF)
    r = moe.route(x.reshape(b * s, -1), router, 2, cap)
    keep_all = torch.zeros(b * s * 2, dtype=torch.bool)
    keep_all[r.order] = r.slot < 4 * cap
    keep_all = keep_all.reshape(b, s, 2)
    ids = expert.reshape(b, s, 2)
    bb, sc = b // rows, s // cols
    blocks = [ids[i * bb:(i + 1) * bb, j * sc:(j + 1) * sc]
              for i in range(rows) for j in range(cols)]
    monkeypatch.setattr(comm, "gather", lambda t, dim, g: torch.cat(
        [blk.to(t.dtype)[None] for blk in blocks], dim))
    for idx, blk in enumerate(blocks):
        g = AxisGroup(tuple(range(rows * cols)), idx)
        keep, counts = moe.global_routing(
            blk.reshape(bb * sc, 2), (bb, sc), 4, cap,
            moe.TokenSplit(g, rows, cols))
        i, j = divmod(idx, cols)
        want = keep_all[i * bb:(i + 1) * bb, j * sc:(j + 1) * sc]
        assert torch.equal(keep.reshape(bb, sc, 2), want)
        assert torch.equal(counts, torch.bincount(expert[:, 0],
                                                  minlength=4))


CHILD = textwrap.dedent('''
    import json, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    mode, pid, hostfile, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], \\
        sys.argv[4]
    axes, sp, cf = json.loads(sys.argv[5]), sys.argv[6], float(sys.argv[7])
    from singa_tpu_torch.core.trainer import Trainer
    from singa_tpu_torch.models.transformer import transformer_lm
    from singa_tpu_torch.parallel.bootstrap import distributed_init
    from singa_tpu_torch.parallel.mesh import make_mesh
    from singa_tpu_torch.parallel.partition import DataParallel
    from singa_tpu_torch.weights import params_from_numpy
    assert distributed_init(pid, hostfile)
    dp = DataParallel(make_mesh(**axes))
    cfg = transformer_lm(**%(LM)r, seq_parallel=sp, train_steps=2)
    for layer in cfg.neuralnet.layer:
        if layer.moe_param is not None:
            layer.moe_param.capacity_factor = cf
    tr = Trainer(cfg, %(SEQ)r, device="cpu", log_fn=lambda s: None, dp=dp)
    p = dp.shard_params(params_from_numpy(
        tr.train_net, dict(np.load(f"{out}/init.npz")), device="cpu"))
    o = tr.updater.init(p)
    b = np.load(f"{out}/batch.npz")
    batch = {"data": {f: torch.tensor(b[f]) for f in ("input", "target")}}
    local = {k: list(v.shape) for k, v in p.items()}
    if mode == "ckpt":
        cfg.checkpoint_frequency = 2
        p, o, _ = tr.run(p, o, iter([batch, batch]), workspace=f"{out}/ws")
    else:
        p, o, m = tr.train_step(p, o, batch, 0)
    whole = dp.gather_params(p)
    np.savez(f"{out}/{mode}_{pid}.npz", local=json.dumps(local),
             loss=float(m["loss"]) if mode != "ckpt" else 0.0,
             aux=float(m["moe0/aux"]) if mode != "ckpt" else 0.0,
             digest=dp.agree(p), **{k: v.numpy() for k, v in whole.items()})
''' % {"LM": LM, "SEQ": SEQ})


def _spawn(tmp, mode, axes, sp):
    n = int(np.prod(list(axes.values())))
    child = tmp / "child.py"
    child.write_text(CHILD)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    hostfile = tmp / f"hostfile_{mode}"
    hostfile.write_text("\n".join([f"127.0.0.1:{port}", "localhost",
                                   "127.0.0.2", "127.0.0.3"][:n]) + "\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for var in ENV_VARS:
        env.pop(var, None)
    procs = [subprocess.Popen(
        [sys.executable, str(child), mode, str(i), str(hostfile), str(tmp),
         json.dumps(axes), sp, str(CF)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} exited {p.returncode}:\n{out}"
    return [np.load(tmp / f"{mode}_{i}.npz") for i in range(n)]


@pytest.mark.parametrize("axes,sp", [
    (dict(data=2), "none"), (dict(seq=2), "ring"),
    (dict(data=2, expert=2), "none")], ids=["dp2", "sp2", "dp2_ep2"])
def test_moe_steps_match_the_jax_global_batch_step(case, axes, sp):
    """One Adam step of the kMoE LM over the mesh equals the JAX
    single-device step on the global batch, its aux loss too; the ranks
    agree; under an expert axis each rank holds 2 of the 4 experts."""
    tmp = case["tmp"]
    runs = _spawn(tmp, "step", axes, sp)
    assert len({str(r["digest"]) for r in runs}) == 1
    got = runs[0]
    assert float(got["loss"]) == pytest.approx(case["loss"], rel=1e-4)
    assert float(got["aux"]) == pytest.approx(case["aux"], rel=1e-4)
    for k, v in case["want"].items():
        np.testing.assert_allclose(got[k], v, rtol=2e-3, atol=1e-5,
                                   err_msg=k)
    ep = axes.get("expert", 1)
    for r in runs:
        local = json.loads(str(r["local"]))
        for name in ("w1", "b1", "w2", "b2"):
            assert local[f"moe1/{name}"][0] == 4 // ep, (name, local)
        assert local["moe1/router"] == [32, 4]


def test_expert_parallel_checkpoint_resumes_on_one_process(case):
    """Saved by rank 0 under data=2 x expert=2: whole (4 experts) and
    spec-shaped, equal to the ranks' gathered params; one process
    resumes it."""
    from singa_tpu_torch.core.trainer import Trainer
    tmp = case["tmp"]
    runs = _spawn(tmp, "ckpt", dict(data=2, expert=2), "none")
    rp, ro, step = CheckpointManager(str(tmp / "ws")).restore()
    assert step == 2
    tr = Trainer(_moe_cfg(transformer_lm, train_steps=3), SEQ,
                 device="cpu", log_fn=lambda s: None)
    for k, spec in tr.train_net.param_specs.items():
        assert rp[k].shape == spec.shape and \
            ro["update"][k].shape == spec.shape, k
        np.testing.assert_array_equal(rp[k], runs[0][k], err_msg=k)
    p, o, start = tr.resume(*tr.init(0), str(tmp / "ws"))
    assert start == 2
    p, o, m = tr.train_step(p, o, case["batch"], 2)
    assert np.isfinite(float(m["loss"]))
