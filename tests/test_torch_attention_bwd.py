"""The flash backward of the PyTorch port against the JAX package, in f32
on the CPU: the plain versions of K3 and K4 against the interpret-mode
dq/dkv Pallas kernels (`_packed_backward`), the autograd Function's q/k/v
gradients on the packed, lse and strided routes against `jax.vjp` of the
JAX wrappers, and the gradients of the fused and chunked LM heads.

Inputs are made with numpy from a seed and handed to both sides.
Attention gradients: rtol 1e-3, atol 1e-4, as the JAX package's own
backward tests (tests/test_sequence.py:362-363) — both sides sum the same
recomputed tiles in another order.  Head gradients: rtol 1e-4 and an atol
of 1e-6 of the largest gradient, f32 sums over E and over chunks in
another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.ops import attention as jattn
from singa_tpu.ops import head_loss as jhead
from singa_tpu.ops import loss as jloss
from singa_tpu_torch.ops import attention as tattn
from singa_tpu_torch.ops import head_loss as thead
from singa_tpu_torch.ops import loss as tloss

pytestmark = pytest.mark.port
RTOL, ATOL = 1e-3, 1e-4
B, S, H, HKV, D = 2, 256, 4, 2, 32
BLOCK = 128


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("causal,with_dlse", [(False, False), (True, False),
                                              (True, True)])
def test_plain_k3_k4_match_interpret_kernels(causal, with_dlse):
    q, k, v, do, dl = _arrays(11 + causal + 2 * with_dlse, (B, S, H * D),
                              (B, S, HKV * D), (B, S, HKV * D),
                              (B, S, H * D), (B, S, H))
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    out, lse = jattn._packed_forward(jq, jk, jv, H, causal, BLOCK, BLOCK,
                                     True, HKV)
    want = jattn._packed_backward(jq, jk, jv, out, lse, jdo, H, causal,
                                  BLOCK, BLOCK, True, HKV,
                                  dlse=jnp.asarray(dl) if with_dlse
                                  else None)
    t = [torch.from_numpy(np.asarray(a)) for a in (q, k, v, do, out, lse)]
    delta = (t[3] * t[4]).reshape(B, S, H, D).sum(-1)
    if with_dlse:
        delta = delta - torch.from_numpy(dl)
    args = (t[0], t[1], t[2], t[3], t[5], delta, H, causal, HKV)
    got = (tattn.flash_dq_plain(*args), *tattn.flash_dkv_plain(*args))
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def _port(*arrays):
    return [torch.from_numpy(a).requires_grad_() for a in arrays]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("route", ["packed", "lse", "strided"])
def test_function_gradients_match_jax_vjp(route, causal):
    """Autograd through `_FlashPacked` (K1 forward, plain K3/K4 backward
    on the CPU) against `jax.vjp` of the same JAX entry point, at batch
    1."""
    if route == "strided":
        shapes = [(1, H, S, D)] * 3
        q, k, v, do = _arrays(21 + causal, *shapes, (1, H, S, D))

        def jf(*a):
            return jattn.flash_attention(*a, causal, BLOCK, BLOCK, True)

        def tf(*a):
            return tattn.flash_attention(*a, causal)
        cots = (do,)
    else:
        q, k, v, do, dl = _arrays(31 + causal, (1, S, H * D),
                                  (1, S, HKV * D), (1, S, HKV * D),
                                  (1, S, H * D), (1, S, H))
        if route == "packed":
            def jf(*a):
                return jattn.flash_attention_packed(
                    *a, H, causal, BLOCK, BLOCK, True, HKV)

            def tf(*a):
                return tattn.flash_attention_packed(*a, H, causal, HKV)
            cots = (do,)
        else:
            def jf(*a):
                return jattn.flash_attention_packed_lse(
                    *a, H, causal, BLOCK, BLOCK, True, HKV)

            def tf(*a):
                return tattn.flash_attention_packed_lse(*a, H, causal, HKV)
            cots = (do, dl)
    _, vjp = jax.vjp(jf, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(cots[0]) if len(cots) == 1
               else tuple(map(jnp.asarray, cots)))
    tq, tk, tv = _port(q, k, v)
    touts = tf(tq, tk, tv)
    touts = touts if isinstance(touts, tuple) else (touts,)
    got = torch.autograd.grad(touts, (tq, tk, tv),
                              [torch.from_numpy(c) for c in cots])
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def _head_close(got, want):
    want = np.asarray(want)
    _close(got, want, rtol=1e-4, atol=1e-6 * np.abs(want).max())


def test_fused_head_gradients_match_jax():
    n, e, vocab = 512, 128, 2048
    h, w = _arrays(41, (n, e), (vocab, e))
    w = (w / np.sqrt(e)).astype(np.float32)
    labels = np.random.default_rng(42).integers(0, vocab, n).astype(np.int32)

    def jloss_fn(hh, ww):
        return jhead.fused_lm_xent(hh, ww, jnp.asarray(labels), 2.0, 128,
                                   512, 2048, True)[0]
    jl, (jdh, jdw) = jax.value_and_grad(jloss_fn, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    th, tw = _port(h, w)
    tl, _ = thead.fused_lm_xent(th, tw, torch.from_numpy(labels), 2.0, 128)
    dh, dw = torch.autograd.grad(tl, (th, tw))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    _head_close(dh.numpy(), jdh)
    _head_close(dw.numpy(), jdw)


@pytest.mark.parametrize("w_is_vE", [False, True])
def test_chunked_head_gradients_match_jax(w_is_vE):
    n, e, vocab = 512, 64, 1024
    h, w = _arrays(51 + w_is_vE, (n, e), (vocab, e) if w_is_vE
                   else (e, vocab))
    w = (w / np.sqrt(e)).astype(np.float32)
    labels = np.random.default_rng(52).integers(0, vocab, n).astype(np.int32)

    def jloss_fn(hh, ww):
        return jloss.chunked_lm_xent(hh, ww, jnp.asarray(labels), 128, 1,
                                     0.5, w_is_vE)[0]
    jl, (jdh, jdw) = jax.value_and_grad(jloss_fn, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    th, tw = _port(h, w)
    tl, _ = tloss.chunked_lm_xent(th, tw, torch.from_numpy(labels), 128, 1,
                                  0.5, w_is_vE)
    dh, dw = torch.autograd.grad(tl, (th, tw))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    _head_close(dh.numpy(), jdh)
    _head_close(dw.numpy(), jdw)


def test_backward_wrappers_take_plain_versions_on_cpu():
    """CPU tensors run the plain K3/K4 versions, and no kernel is
    counted; the lse output's gradient reaches q, k and v alone."""
    from singa_tpu_torch.ops import _kernels
    q, k, v = _port(*_arrays(61, (1, 128, 64), (1, 128, 32), (1, 128, 32)))
    before = dict(_kernels.LAUNCHES)
    _, lse = tattn.flash_attention_packed_lse(q, k, v, 4, True, 2)
    grads = torch.autograd.grad(lse.sum(), (q, k, v))
    assert all(torch.isfinite(g).all() for g in grads)
    assert float(grads[2].abs().max()) == 0.0   # lse does not depend on v
    assert _kernels.LAUNCHES == before


def test_backward_wrappers_check_shapes():
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(
        62, (1, 128, 64), (1, 128, 32), (1, 128, 32), (1, 128, 64)))
    lse = torch.zeros(1, 128, 4)
    for bad in (dict(dout=do[:, :64]), dict(lse=lse[..., :2]),
                dict(k=k[..., :16])):
        args = {**dict(q=q, k=k, v=v, dout=do, lse=lse, delta=lse), **bad}
        with pytest.raises(ValueError):
            tattn.flash_dq(**args, num_heads=4, causal=True, num_kv_heads=2)
        with pytest.raises(ValueError):
            tattn.flash_dkv(**args, num_heads=4, causal=True, num_kv_heads=2)
