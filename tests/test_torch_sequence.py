"""Sequence parallelism in the port, on the CPU: the ring-attention helpers
of `singa_tpu_torch/ops/attention.py` against the JAX package's, RoPE's
absolute positions on a seq chunk, and `ring_attention` and
`ulysses_attention` (`parallel/sequence.py`) on 2- and 4-process gloo
groups against the JAX package's on `make_mesh(seq=2)` and
`make_mesh(seq=4)` over the virtual CPU devices.  The train steps under
a seq axis are in `tests/test_torch_tensor_parallel.py`; the shipped
2x2x2 mesh of `examples/transformer/cluster.conf` (8 processes) runs
only on the card, `chip_smoke.py` phase 20d.

The same numpy-seeded inputs go through both packages, in f32, and every
comparison holds the JAX package's own tolerance for these functions
(`tests/test_sequence.py`: rtol 1e-4, atol 1e-5): outputs, the lse where
a helper returns it, and the gradients of q, k and v under a random
cotangent (and a random lse cotangent where there is an lse).  JAX's
`flash_chunk` runs its Pallas kernels in interpret mode; the port's
runs the plain versions of K1, K3 and K4.  Each spawned group runs every
ring and Ulysses case in one launch; the process groups use hostfiles of
distinct lines (`127.0.0.1:<port>`, `localhost`, `127.0.0.2`,
`127.0.0.3`), as `tests/test_torch_distributed.py` does.
"""

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

from singa_tpu.ops import attention as jatt
from singa_tpu.parallel import make_mesh as jmake_mesh
from singa_tpu.parallel import ring_attention as jring
from singa_tpu.parallel import ulysses_attention as julysses

from singa_tpu_torch.core.layers import Context
from singa_tpu_torch.core.net import build_net
from singa_tpu_torch.models.transformer import transformer_lm
from singa_tpu_torch.ops import attention as tatt
from singa_tpu_torch.parallel.comm import AxisGroup
from singa_tpu_torch.weights import numpy_params, params_from_numpy

from port_fixture import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.port
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-5)


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=what, **TOL)


def _port_grads(fn, arrays, cotangents):
    """fn's outputs and the grads of sum(out_i * cot_i) over `arrays`."""
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    outs = fn(*ts)
    outs = outs if isinstance(outs, tuple) else (outs,)
    sum(torch.sum(o * torch.tensor(c)) for o, c in zip(outs, cotangents)
        ).backward()
    return ([o.detach().numpy() for o in outs],
            [t.grad.numpy() for t in ts])


def _jax_grads(fn, arrays, cotangents):
    def loss(*xs):
        outs = fn(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cotangents)), outs
    (_, outs), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(arrays))), has_aux=True))(
        *[jnp.asarray(a) for a in arrays])
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _check_both(tfn, jfn, arrays, cotangents):
    t_out, t_g = _port_grads(tfn, arrays, cotangents)
    j_out, j_g = _jax_grads(jfn, arrays, cotangents)
    for i, (a, b) in enumerate(zip(t_out, j_out)):
        _close(a, b, f"output {i}")
    for i, (a, b) in enumerate(zip(t_g, j_g)):
        _close(a, b, f"grad {i}")


# -- the eight helpers -------------------------------------------------------

@pytest.mark.parametrize("causal,q_off,kv_off", [
    (True, 32, 0), (True, 0, 32), (True, 16, 16), (False, 0, 32)])
def test_chunk_attention_matches_jax(causal, q_off, kv_off):
    """(0, 32) is a fully masked chunk: zeros, NEG_INF and no NaN."""
    q, k, v, w, wl = _arrays(1, (2, 3, 32, 16), (2, 3, 32, 16),
                             (2, 3, 32, 16), (2, 3, 32, 16), (2, 3, 32, 1))
    _check_both(
        lambda q, k, v: tatt.chunk_attention(q, k, v, causal, q_off, kv_off),
        lambda q, k, v: jatt.chunk_attention(q, k, v, causal, q_off, kv_off),
        [q, k, v], [w, wl])
    out, lse = tatt.chunk_attention(*map(torch.tensor, (q, k, v)), causal,
                                    q_off, kv_off)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()


def test_merge_attention_matches_jax():
    o1, o2, w = _arrays(2, (2, 2, 16, 8), (2, 2, 16, 8), (2, 2, 16, 8))
    l1, l2, wl = _arrays(3, (2, 2, 16, 1), (2, 2, 16, 1), (2, 2, 16, 1))
    l1[:, :, :4] = tatt.NEG_INF         # rows one side has not seen yet
    _check_both(tatt.merge_attention, jatt.merge_attention, [o1, l1, o2, l2],
                [w, wl])


@pytest.mark.parametrize("sk,block_k", [(128, 32), (96, 64)])
def test_chunk_attention_blockwise_matches_jax(sk, block_k):
    """128 in blocks of 32 takes the sub-block scan; 96 does not tile 64
    and takes `chunk_attention` whole, in both packages."""
    q, k, v, w, wl = _arrays(4, (1, 2, 32, 16), (1, 2, sk, 16),
                             (1, 2, sk, 16), (1, 2, 32, 16), (1, 2, 32, 1))
    _check_both(
        lambda q, k, v: tatt.chunk_attention_blockwise(q, k, v, True, 64, 0,
                                                       block_k),
        lambda q, k, v: jatt.chunk_attention_blockwise(q, k, v, True, 64, 0,
                                                       block_k),
        [q, k, v], [w, wl])


@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_attention_matches_jax(causal):
    q, k, v, w = _arrays(5, *[(1, 2, 128, 16)] * 4)
    _check_both(
        lambda q, k, v: tatt.blockwise_attention(q, k, v, causal, 32),
        lambda q, k, v: jatt.blockwise_attention(q, k, v, causal, 32),
        [q, k, v], [w])


@pytest.mark.parametrize("causal", [True, False])
def test_flash_chunk_matches_the_interpreted_pallas_kernels(causal):
    """Forward, and backward with a nonzero lse cotangent, which K3 and
    K4's plain versions take folded into delta."""
    q, k, v, w = _arrays(6, *[(2, 2, 128, 16)] * 4)
    (wl,) = _arrays(7, (2, 2, 128, 1))
    _check_both(
        lambda q, k, v: tatt.flash_chunk(q, k, v, causal),
        lambda q, k, v: jatt.flash_chunk(q, k, v, causal, True),
        [q, k, v], [w, wl])


def test_flash_chunk_legal_and_flash_blocks_match_jax():
    for sq, sk, d in [(128, 128, 16), (12, 12, 16), (24, 48, 8),
                      (64, 64, 12), (4, 4, 8), (1000, 1000, 64)]:
        assert tatt.flash_chunk_legal(sq, sk, d) == \
            jatt.flash_chunk_legal(sq, sk, d), (sq, sk, d)
    for s in (128, 512, 1024, 4096):
        assert tatt.flash_blocks(s) == jatt.flash_blocks(s)
    tatt.set_flash_blocks((256, 256))
    jatt.set_flash_blocks((256, 256))
    try:
        assert tatt.flash_blocks(4096) == jatt.flash_blocks(4096) \
            == (256, 256)
    finally:
        tatt.set_flash_blocks(None)
        jatt.set_flash_blocks(None)
    assert tatt.flash_blocks(4096) == (512, 1024)


# -- RoPE on a seq chunk -----------------------------------------------------

def test_rope_positions_on_a_seq_chunk_are_the_global_positions_slice():
    """kAttention's q and k on seq chunk i of n equal chunk i of the
    whole sequence's (and so the JAX package's `rope` at global
    positions)."""
    cfg = transformer_lm(vocab_size=32, num_layers=1, embed_dim=32,
                         num_heads=2, head_dim=16, seq_len=64, batchsize=2,
                         seq_parallel="ring")
    net = build_net(cfg, "kTrain", {"data": {"input": (64,),
                                             "target": (64,)}})
    layer = net.layers["attn0"]
    params = params_from_numpy(net, numpy_params(net, seed=0), device="cpu")
    (x,) = _arrays(8, (2, 64, 32))
    x = torch.tensor(x)
    q, k, _ = layer.qkv(params, x, torch.arange(64))
    jq = jatt.rope(jnp.asarray(torch.einsum(
        "bse,ed->bsd", x, params["attn0/wq"]).reshape(2, 64, 2, 16)
        .transpose(1, 2).numpy()), jnp.arange(64))
    _close(q.detach().numpy(), jq)
    n = 4
    for i in range(n):
        ctx = Context(batch={}, train=True, seq=AxisGroup(tuple(range(n)), i))
        from singa_tpu_torch.core.seq_layers import _positions
        pos = _positions(ctx, 64 // n, x.device)
        assert pos.tolist() == list(range(i * 16, (i + 1) * 16))
        qc, kc, _ = layer.qkv(params, x[:, i * 16:(i + 1) * 16], pos)
        torch.testing.assert_close(qc, q[:, :, i * 16:(i + 1) * 16])
        torch.testing.assert_close(kc, k[:, :, i * 16:(i + 1) * 16])


def test_a_seq_chunk_draws_its_columns_of_the_global_dropout_mask():
    """kDropout on rows r and sequence chunk i keeps that block of the
    global batch's mask (`Context.global_rows`, `global_cols`)."""
    from singa_tpu_torch.ops.dropout import dropout
    x = torch.ones(4, 12, 8)
    gen = torch.Generator().manual_seed(3)
    whole = dropout(x, 0.5, gen)
    for i in range(3):
        gen = torch.Generator().manual_seed(3)
        ctx = Context(batch={}, train=True, shard=(1, 2),
                      seq=AxisGroup((0, 1, 2), i))
        part = dropout(x[2:, 4 * i:4 * (i + 1)], 0.5, gen,
                       rows=ctx.global_rows(2), cols=ctx.global_cols(4))
        torch.testing.assert_close(part, whole[2:, 4 * i:4 * (i + 1)],
                                   rtol=0, atol=0)


# -- ring and Ulysses over processes -----------------------------------------

# name → (kind, causal, S per rank): H=4 q heads, Hkv=2 kv heads, D=16;
# "blockwise" chunks of 12 do not tile the kernels' rule, so both
# packages take `chunk_attention_blockwise`
CASES = {
    "ring_causal": ("ring", True, 32),
    "ring_full": ("ring", False, 32),
    "ring_blockwise": ("ring", True, 12),
    "ulysses_causal": ("ulysses", True, 32),
    "ulysses_full": ("ulysses", False, 32),
}

CHILD = textwrap.dedent('''
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    pid, hostfile, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    from singa_tpu_torch.parallel.bootstrap import (distributed_init,
                                                    process_count)
    from singa_tpu_torch.parallel.mesh import make_mesh
    from singa_tpu_torch.parallel.partition import DataParallel
    from singa_tpu_torch.parallel.sequence import (ring_attention,
                                                   ulysses_attention)
    assert distributed_init(pid, hostfile)
    n = process_count()
    g = DataParallel(make_mesh(seq=n)).seq_group
    assert g.ranks == tuple(range(n)) and g.index == pid
    data = np.load(f"{out}/inputs.npz")
    res = {}
    for name in sorted({k.rsplit("_", 1)[0] for k in data.files}):
        q, k, v, w = (torch.tensor(data[f"{name}_{x}"]) for x in "qkvw")
        causal = "full" not in name
        c = q.shape[2] // n
        sl = slice(pid * c, (pid + 1) * c)
        ql, kl, vl = (t[:, :, sl].clone().requires_grad_(True)
                      for t in (q, k, v))
        fn = ring_attention if name.startswith("ring") else ulysses_attention
        o = fn(ql, kl, vl, g, causal)
        torch.sum(o * w[:, :, sl]).backward()
        for x, t in zip("oqkv", (o, ql.grad, kl.grad, vl.grad)):
            res[f"{name}_{x}"] = t.detach().numpy()
    np.savez(f"{out}/seq_{pid}.npz", **res)
''')


def _hostfile(path, n):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    lines = [f"127.0.0.1:{port}", "localhost", "127.0.0.2", "127.0.0.3"][:n]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture(scope="module", params=[2, 4], ids=["seq2", "seq4"])
def seq_run(request, tmp_path_factory):
    """Each case's inputs, the port's output and grads from an n-process
    group (chunks joined in seq order), and the JAX package's."""
    n = request.param
    tmp = tmp_path_factory.mktemp(f"seq{n}")
    inputs, want = {}, {}
    mesh = jmake_mesh(jax.devices()[:n], seq=n)
    for i, (name, (kind, causal, per)) in enumerate(sorted(CASES.items())):
        s = per * n
        q, k, v, w = _arrays(10 + i, (2, 4, s, 16), (2, 2, s, 16),
                             (2, 2, s, 16), (2, 4, s, 16))
        inputs.update({f"{name}_q": q, f"{name}_k": k, f"{name}_v": v,
                       f"{name}_w": w})
        fn = jring if kind == "ring" else julysses
        (o,), grads = _jax_grads(
            lambda q, k, v, fn=fn, causal=causal: fn(q, k, v, mesh, "seq",
                                                     causal),
            [q, k, v], [w])
        want[name] = [o, *grads]
    np.savez(tmp / "inputs.npz", **inputs)
    child = tmp / "child.py"
    child.write_text(CHILD)
    hostfile = _hostfile(tmp / "hostfile", n)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                "JAX_PROCESS_ID"):
        env.pop(var, None)
    procs = [subprocess.Popen([sys.executable, str(child), str(i), hostfile,
                               str(tmp)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(n)]
    try:
        outs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i}:\n{out}"
    parts = [np.load(tmp / f"seq_{i}.npz") for i in range(n)]
    got = {name: [np.concatenate([p[f"{name}_{x}"] for p in parts], axis=2)
                  for x in "oqkv"] for name in CASES}
    return got, want


@pytest.mark.parametrize("name", sorted(CASES))
def test_sequence_parallel_attention_matches_jax(seq_run, name):
    """Output and dq, dk, dv of ring or Ulysses attention, GQA (kv at
    Hkv width), against the JAX package's on the same mesh shape."""
    got, want = seq_run
    for what, a, b in zip(("out", "dq", "dk", "dv"), got[name], want[name]):
        _close(a, b, f"{name} {what}")


def test_ring_with_a_seq_axis_of_one_is_the_dense_route():
    """As in the JAX package (`sequence.py:113-115`): no ring, and at a
    length the flash kernels do not tile, the dense reference."""
    from singa_tpu_torch.parallel.sequence import ring_attention
    q, k, v = _arrays(20, (1, 4, 24, 8), (1, 2, 24, 8), (1, 2, 24, 8))
    got = ring_attention(*map(torch.tensor, (q, k, v)), AxisGroup((0,), 0))
    want = jatt.attention_reference(
        jnp.asarray(q), jatt.expand_kv_heads(jnp.asarray(k), 4),
        jatt.expand_kv_heads(jnp.asarray(v), 4), True)
    _close(got.numpy(), want)


def test_ring_with_a_seq_axis_of_one_takes_the_strided_flash_kernels(
        monkeypatch):
    """Where the kernels tile, a seq axis of 1 runs the strided flash
    route (K1 forward, K3/K4 backward on the card), the same function as
    the JAX package's dense one: so a mesh without a seq axis keeps its
    ring layers on the kernels."""
    from singa_tpu_torch.ops import attention as A
    from singa_tpu_torch.parallel.sequence import ring_attention
    calls = []
    flash = A.flash_attention
    monkeypatch.setattr(A, "flash_attention",
                        lambda *a: calls.append(1) or flash(*a))
    q, k, v = _arrays(21, (1, 4, 128, 16), (1, 2, 128, 16),
                      (1, 2, 128, 16))
    for causal in (True, False):
        got = ring_attention(*map(torch.tensor, (q, k, v)),
                             AxisGroup((0,), 0), causal)
        want = jatt.attention_reference(
            jnp.asarray(q), jatt.expand_kv_heads(jnp.asarray(k), 4),
            jatt.expand_kv_heads(jnp.asarray(v), 4), causal)
        _close(got.numpy(), want)
    assert len(calls) == 2
