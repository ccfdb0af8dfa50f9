"""K2's plain version and the loss ops of the PyTorch port against the
JAX package: the interpret-mode fused head kernel, `fused_lm_xent`, the
chunked head, the dense metrics, the tie rule and the exact label logit
(the cases of tests/test_head_loss.py).

N=64, E=128, V=512 with the JAX kernel tiled BN=16, BV=128, inputs from
numpy in f32, and in bf16 (rounded once and handed to both sides).
Tolerance rtol 1e-5 on lse, label logit and the loss: in both dtypes the
two sides sum the same exact products in f32, in another order; hits are
compared exactly.  Then the bf16 kernel's legality rule and its split of
V with the merge of the ranges (`head_stats_split_plain`), ties across a
range boundary included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.ops import head_loss as jhead
from singa_tpu.ops import loss as jloss
from singa_tpu_torch.ops import head_loss as thead
from singa_tpu_torch.ops import loss as tloss

from port_fixture import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.port
N, E, V = 64, 128, 512
BN, BV = 16, 128


def _data(seed=0):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((N, E)).astype(np.float32)
    w = (rng.standard_normal((V, E)) * 0.05).astype(np.float32)
    labels = rng.integers(0, V, (N,)).astype(np.int32)
    return h, w, labels


def _jax_stats(h, w, labels):
    return [np.asarray(a) for a in jhead._head_stats_pallas(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels), BN, BV, True)]


def _torch_stats(h, w, labels):
    return [a.numpy() for a in thead.head_stats_plain(
        torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(labels),
        bv=BV)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_k2_matches_interpret_kernel(seed):
    h, w, labels = _data(seed)
    lse_j, ll_j, hit_j = _jax_stats(h, w, labels)
    lse_t, ll_t, hit_t = _torch_stats(h, w, labels)
    np.testing.assert_allclose(lse_t, lse_j, rtol=1e-5)
    np.testing.assert_allclose(ll_t, ll_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(hit_t, hit_j)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_k2_bf16_matches_interpret_kernel(seed):
    """K2 in bf16, the dtype the LM trains and scores in: the plain
    version on bf16 h and W against the interpret-mode Pallas kernel on
    the same bf16 arrays."""
    h, w, labels = _data(10 + seed)
    jh, jw = (jnp.asarray(a, dtype=jnp.bfloat16) for a in (h, w))
    th, tw = (torch.from_numpy(a).to(torch.bfloat16) for a in (h, w))
    want = [np.asarray(a) for a in jhead._head_stats_pallas(
        jh, jw, jnp.asarray(labels), BN, BV, True)]
    got = [a.numpy() for a in thead.head_stats_plain(
        th, tw, torch.from_numpy(labels), bv=BV)]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[2], want[2])


def test_k2_bf16_operands_need_16_byte_rows():
    """The bf16 tensor-core body copies rows of h and W in 16-byte
    pieces: E not a multiple of 8, or an operand that does not start on
    16 bytes, is refused before any launch; f32 takes any E."""
    h = torch.zeros(N, 96, dtype=torch.bfloat16)
    w = torch.zeros(V, 96, dtype=torch.bfloat16)
    thead._check_mma(h, w)
    with pytest.raises(ValueError):
        thead._check_mma(h[:, :92].contiguous(), w[:, :92].contiguous())
    shifted = torch.zeros(1 + V * 96, dtype=torch.bfloat16)[1:]
    with pytest.raises(ValueError):
        thead._check_mma(h, shifted.view(V, 96))
    with pytest.raises(ValueError):
        thead._check_mma(shifted[:N * 96].view(N, 96), w)
    thead._check_mma(h[:, :92].float(), w[:, :92].float())


@pytest.mark.parametrize("v", [512, 1000, 4200])
def test_v_splits_cover_the_vocab(v):
    """At most MAX_SPLITS ranges of whole 128-column tiles, none empty,
    covering every column."""
    ranges, per = thead.v_splits(v)
    tiles = -(-v // thead.MMA_BV)
    assert 1 <= ranges <= thead.MAX_SPLITS
    assert (ranges - 1) * per < tiles <= ranges * per


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v", [V, 1000])
def test_split_merge_matches_plain(dtype, v):
    """Merging the bf16 kernel's V ranges in V order gives
    `head_stats_plain`'s statistics, and the lowest column wins a tie
    across a range boundary: columns b - 1 and b (the first of the
    second range) hold equal rows of W whose logit beats every other."""
    rng = np.random.default_rng(20 + v)
    h = rng.standard_normal((N, E)).astype(np.float32)
    w = (rng.standard_normal((v, E)) * 0.05).astype(np.float32)
    _, per = thead.v_splits(v)
    b = per * thead.MMA_BV
    h[:, 0] = 8.0
    w[:, 0] = 0.0
    w[b - 1] = w[b] = 0.0
    w[b - 1, 0] = w[b, 0] = 1.0       # logit exactly 8 at both columns
    labels = rng.integers(0, v, (N,)).astype(np.int32)
    labels[labels == b - 1] = 0
    labels[: N // 2] = b - 1
    labels[N // 2: 3 * N // 4] = b
    th, tw = (torch.from_numpy(a).to(dtype) for a in (h, w))
    tl = torch.from_numpy(labels)
    got = thead.head_stats_split_plain(th, tw, tl)
    want = thead.head_stats_plain(th, tw, tl)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    np.testing.assert_array_equal(got[2].numpy(), want[2].numpy())
    hit = got[2].numpy()
    assert (hit[: N // 2] == 1).all() and (hit[N // 2:] == 0).all()
    np.testing.assert_array_equal(got[1].numpy()[: 3 * N // 4], 8.0)


def test_fused_xent_matches_jax():
    h, w, labels = _data(3)
    loss_j, prec_j = jhead.fused_lm_xent(jnp.asarray(h), jnp.asarray(w),
                                         jnp.asarray(labels), 2.0, 4096,
                                         BN, BV, True)
    loss_t, prec_t = thead.fused_lm_xent(torch.from_numpy(h),
                                         torch.from_numpy(w),
                                         torch.from_numpy(labels), 2.0)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    assert float(prec_t) == float(prec_j)


def test_argmax_tie_lowest_index_wins():
    """All logits equal: column 0 is the argmax on both sides."""
    h = np.zeros((N, E), np.float32)
    w = np.zeros((V, E), np.float32)
    for lbl, want in ((0, 1.0), (1, 0.0)):
        labels = np.full((N,), lbl, np.int32)
        _, _, hit_j = _jax_stats(h, w, labels)
        _, _, hit_t = _torch_stats(h, w, labels)
        assert (hit_t == want).all() and (hit_j == want).all()


def test_label_logit_exact():
    """Labels at each row's argmax: every row hits, and the loss is the
    dense oracle's, so the label logit is the exact one."""
    h, w, _ = _data(4)
    logits = h @ w.T
    labels = np.argmax(logits, axis=1).astype(np.int32)
    loss_t, prec_t = thead.fused_lm_xent(torch.from_numpy(h),
                                         torch.from_numpy(w),
                                         torch.from_numpy(labels))
    loss_d, _ = jloss.softmax_loss_metrics(jnp.asarray(logits),
                                           jnp.asarray(labels))
    assert float(prec_t) == 1.0
    np.testing.assert_allclose(float(loss_t), float(loss_d), rtol=1e-5)
    _, ll_j, _ = _jax_stats(h, w, labels)
    _, ll_t, _ = _torch_stats(h, w, labels)
    np.testing.assert_allclose(ll_t, ll_j, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("w_is_vE,topk", [(True, 1), (False, 1),
                                          (True, 5)])
def test_chunked_xent_matches_jax(w_is_vE, topk):
    h, w, labels = _data(5)
    if not w_is_vE:
        w = np.ascontiguousarray(w.T)
    loss_j, prec_j = jloss.chunked_lm_xent(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels), chunk_size=16,
        topk=topk, scale=1.5, w_is_vE=w_is_vE)
    loss_t, prec_t = tloss.chunked_lm_xent(
        torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(labels),
        chunk_size=16, topk=topk, scale=1.5, w_is_vE=w_is_vE)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(float(prec_t), float(prec_j), rtol=1e-6)


def test_dense_metrics_match_jax():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((32, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (32,)).astype(np.int32)
    for topk in (1, 3):
        want = jloss.softmax_loss_metrics(jnp.asarray(logits),
                                          jnp.asarray(labels), topk, 0.5)
        got = tloss.softmax_loss_metrics(torch.from_numpy(logits),
                                         torch.from_numpy(labels), topk, 0.5)
        for a, b in zip(got, want):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


def test_eligibility_rule_matches_jax():
    for n, e, v, dt in [(512, 128, 2048, "float32"),
                        (512, 128, 2048, "bfloat16"),
                        (100, 128, 2048, "float32"),
                        (512, 96, 2048, "float32"),
                        (512, 128, 1000, "float32")]:
        jd, td = getattr(jnp, dt), getattr(torch, dt)
        want = jhead.eligible(jnp.zeros((n, e), jd), jnp.zeros((v, e), jd))
        assert thead.eligible(torch.zeros((n, e), dtype=td),
                              torch.zeros((v, e), dtype=td)) == want
    assert not thead.eligible(torch.zeros((512, 128)),
                              torch.zeros((2048, 128), dtype=torch.bfloat16))
