"""K1's, K3's and K4's plain versions in bf16 against the JAX package:
the roundings that the tensor-core kernels make, pinned on the CPU.

In bf16 the kernels fold scale·log2e into q in q's dtype before Q·Kᵀ
(the constant rounded to bf16, then every q·c), as the interpret-mode
Pallas kernels do (`q_ref[...] * jnp.asarray(scale * LOG2E,
q_ref.dtype)`); they round P to the input dtype before P·V (K1), dS
before dS·K (K3), and P and dS before Pᵀ·dO and dSᵀ·Q (K4), as the
Pallas kernels do (`p.astype(v_ref.dtype)`, `ds.astype(k_ref.dtype)`,
`p.astype(do_ref.dtype)`, `ds.astype(q_ref.dtype)`); the plain versions
follow them.  What is left is f32 summation order, where a P or dS
element may round to the neighbouring bf16 value: at these sizes O sat
within half a bf16 ulp of max|O|, lse within 9.6e-7, dK/dV within
0.0018 and dQ within 0.00057 of their largest magnitude.  The
tolerances are about twice that: O one ulp of max|O|, lse 2e-6, dK/dV
2^-8 and dQ 2^-10 of their largest magnitude.

Inputs are made with numpy from a seed, rounded to bf16 once and handed
to both sides."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.ops import attention as jattn
from singa_tpu_torch.ops import attention as tattn

pytestmark = pytest.mark.port
B, S, D = 2, 256, 32
BLOCK = 128
LSE_ATOL = 2e-6
DKV_RTOL = 2 ** -8
DQ_RTOL = 2 ** -10
O_ULPS = 1


def _bf16(seed, *shapes):
    """numpy-seeded normals, rounded to bf16: (jax arrays, torch tensors)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    js = [jnp.asarray(a, dtype=jnp.bfloat16) for a in arrs]
    ts = [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]
    return js, ts


def _f32(x):
    return np.asarray(jnp.asarray(x, dtype=jnp.float32))


def _ulp(top):
    """One bf16 ulp at magnitude `top` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(top)) - 7)


def _jax_fold(d):
    """The TPU kernels' constant: jnp.asarray(scale * LOG2E, bf16)."""
    return float(jnp.asarray((1.0 / math.sqrt(d)) * jattn.LOG2E,
                             jnp.bfloat16))


def test_fold_constant_matches_jax():
    """The port's bf16 fold constant is the TPU kernels' bit for bit at
    every head dim that the card's phase 2 takes (8 to 264), and in f32
    it is the f32 rounding of the same double."""
    for d in range(8, 265):
        assert tattn.fold_constant(d, torch.bfloat16) == _jax_fold(d), d
        assert tattn.fold_constant(d, torch.float32) == float(
            np.float32((1.0 / math.sqrt(d)) * jattn.LOG2E)), d


CASES = [(causal, heads, kv_heads) for causal in (False, True)
         for heads, kv_heads in ((4, 4), (4, 2))]


@pytest.mark.parametrize("causal,heads,kv_heads", CASES)
def test_plain_k1_bf16_matches_interpret_kernel(causal, heads, kv_heads):
    (jq, jk, jv), (tq, tk, tv) = _bf16(
        100 + 10 * causal + kv_heads, (B, S, heads * D),
        (B, S, kv_heads * D), (B, S, kv_heads * D))
    out_j, lse_j = jattn.flash_attention_packed_lse(
        jq, jk, jv, heads, causal, BLOCK, BLOCK, True, kv_heads)
    out_t, lse_t = tattn.flash_forward_plain(tq, tk, tv, heads, causal,
                                             kv_heads)
    assert out_t.dtype == torch.bfloat16 and lse_t.dtype == torch.float32
    want = _f32(out_j)
    top = np.abs(want).max()
    np.testing.assert_allclose(out_t.float().numpy(), want, rtol=0,
                               atol=O_ULPS * _ulp(top))
    np.testing.assert_allclose(lse_t.numpy(), _f32(lse_j), rtol=0,
                               atol=LSE_ATOL)


@pytest.mark.parametrize("causal,heads,kv_heads", CASES)
def test_plain_k4_bf16_matches_interpret_kernel(causal, heads, kv_heads):
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _bf16(
        200 + 10 * causal + kv_heads, (B, S, heads * D),
        (B, S, kv_heads * D), (B, S, kv_heads * D), (B, S, heads * D))
    out, lse = jattn._packed_forward(jq, jk, jv, heads, causal, BLOCK,
                                     BLOCK, True, kv_heads)
    _, dk_j, dv_j = jattn._packed_backward(jq, jk, jv, out, lse, jdo,
                                           heads, causal, BLOCK, BLOCK,
                                           True, kv_heads)
    tout = torch.from_numpy(_f32(out))
    delta = (tdo.float() * tout).reshape(B, S, heads, D).sum(-1)
    dk_t, dv_t = tattn.flash_dkv_plain(
        tq, tk, tv, tdo, torch.from_numpy(np.asarray(lse)), delta, heads,
        causal, kv_heads)
    assert dk_t.dtype == dv_t.dtype == torch.bfloat16
    for got, want in ((dk_t, dk_j), (dv_t, dv_j)):
        want = _f32(want)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=DKV_RTOL * np.abs(want).max())


def _dense_dkv(q, k, v, dout, lse, delta, heads, causal, kv_heads):
    """dK, dV in one shot over every query, in f32, with q·c, P and dS
    rounded to bf16 where the kernel rounds them (c the TPU kernels'
    bf16 constant, dSᵀ·Q on the raw q); GQA by expanding k and v."""
    b, sq, _ = q.shape
    sk, g = k.shape[1], heads // kv_heads
    scale = 1.0 / math.sqrt(D)

    def heads_of(x, n):
        return x.float().reshape(b, -1, n, D).transpose(1, 2)
    qh, doh = heads_of(q, heads), heads_of(dout, heads)
    kh = heads_of(k, kv_heads).repeat_interleave(g, dim=1)
    vh = heads_of(v, kv_heads).repeat_interleave(g, dim=1)
    qc = heads_of(q * _jax_fold(D), heads)     # q·c rounded to bf16
    s = qc @ kh.transpose(-1, -2)
    if causal:
        mask = torch.arange(sq)[:, None] < torch.arange(sk)[None, :]
        s = s.masked_fill(mask, tattn.NEG_INF)
    p = torch.exp2(s - lse.transpose(1, 2)[..., None] * tattn.LOG2E)
    ds = p * (doh @ vh.transpose(-1, -2) - delta.transpose(1, 2)[..., None])
    dv = p.to(torch.bfloat16).float().transpose(-1, -2) @ doh
    dk = ds.to(torch.bfloat16).float().transpose(-1, -2) @ qh * scale

    def packed(x):       # (B, H, Sk, D) -> group sums, (B, Sk, Hkv·D)
        x = x.reshape(b, kv_heads, g, sk, D).sum(2)
        return x.transpose(1, 2).reshape(b, sk, kv_heads * D)
    return packed(dk), packed(dv)


@pytest.mark.parametrize("causal,heads,kv_heads", CASES)
def test_plain_k4_bf16_equals_dense_formula(causal, heads, kv_heads):
    """The tiled plain K4 in bf16 is the dense formula with the same
    fold of the scale into q and the same two roundings, up to f32 summation order: where the two f32 P (or dS)
    differ in their last bit, one element may round to the neighbouring
    bf16 value, an error of one bf16 ulp of one term (2^-8 of it); the
    tolerance is 2^-8 of the largest dK and dV."""
    _, (tq, tk, tv, tdo, tdl) = _bf16(
        300 + 10 * causal + kv_heads, (B, S, heads * D),
        (B, S, kv_heads * D), (B, S, kv_heads * D), (B, S, heads * D),
        (B, S, heads))
    out, lse = tattn.flash_forward_plain(tq, tk, tv, heads, causal,
                                         kv_heads)
    delta = (tdo.float() * out.float()).reshape(B, S, heads, D).sum(-1)
    delta = delta - tdl.float()
    args = (tq, tk, tv, tdo, lse, delta, heads, causal, kv_heads)
    got = tattn.flash_dkv_plain(*args)
    want = _dense_dkv(*args)
    for g, w in zip(got, want):
        top = w.abs().max().item()
        gap = (g.float() - w.to(torch.bfloat16).float()).abs().max().item()
        assert gap <= 2 ** -8 * top, (gap, top)


@pytest.mark.parametrize("causal,heads,kv_heads", CASES)
def test_plain_k3_bf16_matches_interpret_kernel(causal, heads, kv_heads):
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _bf16(
        400 + 10 * causal + kv_heads, (B, S, heads * D),
        (B, S, kv_heads * D), (B, S, kv_heads * D), (B, S, heads * D))
    out, lse = jattn._packed_forward(jq, jk, jv, heads, causal, BLOCK,
                                     BLOCK, True, kv_heads)
    dq_j, _, _ = jattn._packed_backward(jq, jk, jv, out, lse, jdo, heads,
                                        causal, BLOCK, BLOCK, True,
                                        kv_heads)
    tout = torch.from_numpy(_f32(out))
    delta = (tdo.float() * tout).reshape(B, S, heads, D).sum(-1)
    dq_t = tattn.flash_dq_plain(
        tq, tk, tv, tdo, torch.from_numpy(np.asarray(lse)), delta, heads,
        causal, kv_heads)
    assert dq_t.dtype == torch.bfloat16
    want = _f32(dq_j)
    np.testing.assert_allclose(dq_t.float().numpy(), want, rtol=0,
                               atol=DQ_RTOL * np.abs(want).max())


def _dense_dq(q, k, v, dout, lse, delta, heads, causal, kv_heads):
    """dQ in one shot over every key, in f32, with q·c and dS rounded to
    bf16 where the kernel rounds them (c the TPU kernels' bf16
    constant); GQA by expanding k and v."""
    b, sq, _ = q.shape
    sk, g = k.shape[1], heads // kv_heads
    scale = 1.0 / math.sqrt(D)

    def heads_of(x, n):
        return x.float().reshape(b, -1, n, D).transpose(1, 2)
    doh = heads_of(dout, heads)
    kh = heads_of(k, kv_heads).repeat_interleave(g, dim=1)
    vh = heads_of(v, kv_heads).repeat_interleave(g, dim=1)
    qc = heads_of(q * _jax_fold(D), heads)     # q·c rounded to bf16
    s = qc @ kh.transpose(-1, -2)
    if causal:
        mask = torch.arange(sq)[:, None] < torch.arange(sk)[None, :]
        s = s.masked_fill(mask, tattn.NEG_INF)
    p = torch.exp2(s - lse.transpose(1, 2)[..., None] * tattn.LOG2E)
    ds = p * (doh @ vh.transpose(-1, -2) - delta.transpose(1, 2)[..., None])
    dq = ds.to(torch.bfloat16).float() @ kh * scale
    return dq.transpose(1, 2).reshape(q.shape)


@pytest.mark.parametrize("causal,heads,kv_heads", CASES)
def test_plain_k3_bf16_equals_dense_formula(causal, heads, kv_heads):
    """The tiled plain K3 in bf16 is the dense formula with the same fold
    of the scale into q and dS rounded to bf16, up to f32 summation order: where the two f32 dS differ in
    their last bit, one element may round to the neighbouring bf16
    value, an error of one bf16 ulp of one term (2^-8 of it); the
    tolerance is 2^-8 of the largest dQ.  Leaving the rounding out moves
    dQ by 0.34-0.64% of its largest magnitude at these sizes, and fails
    the two non-causal cases here."""
    _, (tq, tk, tv, tdo, tdl) = _bf16(
        500 + 10 * causal + kv_heads, (B, S, heads * D),
        (B, S, kv_heads * D), (B, S, kv_heads * D), (B, S, heads * D),
        (B, S, heads))
    out, lse = tattn.flash_forward_plain(tq, tk, tv, heads, causal,
                                         kv_heads)
    delta = (tdo.float() * out.float()).reshape(B, S, heads, D).sum(-1)
    delta = delta - tdl.float()
    args = (tq, tk, tv, tdo, lse, delta, heads, causal, kv_heads)
    got = tattn.flash_dq_plain(*args)
    want = _dense_dq(*args)
    top = want.abs().max().item()
    gap = (got.float() - want.to(torch.bfloat16).float()).abs().max().item()
    assert gap <= 2 ** -8 * top, (gap, top)


def test_mma_operands_need_16_byte_rows():
    """The tensor-core bodies read bf16 rows in 16-byte pieces: a head dim
    that is not a multiple of 8, or an operand that does not start on 16
    bytes, is refused before any launch."""
    q = torch.zeros(1, 128, 4 * 32, dtype=torch.bfloat16)
    k = torch.zeros(1, 128, 2 * 32, dtype=torch.bfloat16)
    tattn._check_mma("flash_fwd", 32, (q, k, k))
    with pytest.raises(ValueError):
        tattn._check_mma("flash_fwd", 20, (q, k, k))
    shifted = torch.zeros(1 + 128 * 64, dtype=torch.bfloat16)[1:]
    for name in ("flash_dq", "flash_dkv"):
        with pytest.raises(ValueError):
            tattn._check_mma(name, 32, (q, shifted.view(1, 128, 64), k))
    # f32 stays on the scalar bodies, which take any head dim
    tattn._check_mma("flash_fwd", 20, (q.float(),))
