"""`beam_search` in the port against the JAX package's, on the CPU, in
the settings of `tests/test_generate.py:196-293`: more beams than the
vocabulary (the padded -1e30 candidates tie, and the tie order decides
the reorder), width one against greedy, eos freezing, and the length
penalty; its argument checks; and a MoE + GQA net's `forward_cached`,
`generate` and `beam_search` (`tests/test_generate.py:132`).

The same weights (drawn by the JAX package, or with numpy) on both
sides.  Tokens must be equal; scores within 1e-4 (sums of T f32
log-probs, each from logits that the two packages sum in another
order); MoE + GQA logits rtol/atol 2e-4, the JAX test's own tolerance
for cached against full logits."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.core.net import build_net as jbuild_net
from singa_tpu.models.transformer import transformer_lm as jtransformer_lm

from singa_tpu_torch.core.net import build_net as tbuild_net
from singa_tpu_torch.models.transformer import \
    transformer_lm as ttransformer_lm
from singa_tpu_torch.weights import numpy_params, params_from_numpy

jgen = importlib.import_module("singa_tpu.models.generate")
tgen = importlib.import_module("singa_tpu_torch.models.generate")

pytestmark = pytest.mark.port
VOCAB, SEQ, B = 64, 16, 2
SHAPES = {"data": {"input": (SEQ,), "target": (SEQ,)}}


def _nets(seed=0, jax_init=True, **kw):
    """The same net in both packages with the same weights: drawn by
    the JAX package from PRNGKey(seed) (as the JAX tests draw them), or
    with numpy."""
    cfg = dict(vocab_size=VOCAB, num_layers=2, embed_dim=32, num_heads=4,
               head_dim=8, seq_len=SEQ, batchsize=B, fused_head=False)
    cfg.update(kw)
    jnet = jbuild_net(jtransformer_lm(**cfg), "kTest", SHAPES)
    tnet = tbuild_net(ttransformer_lm(**cfg), "kTest", SHAPES)
    if jax_init:
        arrays = jax.tree_util.tree_map(
            np.asarray, jnet.init_params(jax.random.PRNGKey(seed)))
    else:
        arrays = numpy_params(tnet, seed=seed)
    return (jnet, {k: jnp.asarray(v) for k, v in arrays.items()},
            tnet, params_from_numpy(tnet, arrays, device="cpu"))


def _both(nets, prompt, n, **kw):
    jnet, jp, tnet, tp = nets
    jt, js = jgen.beam_search(jnet, jp, jnp.asarray(prompt, jnp.int32), n,
                              **kw)
    tt, ts = tgen.beam_search(tnet, tp, torch.from_numpy(prompt), n, **kw)
    return (np.asarray(jt), np.asarray(js)), (tt.numpy(), ts.numpy())


def _assert_same(j, t):
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_allclose(t[1], j[1], rtol=0, atol=1e-4)


# (net kwargs and seed, prompt, new tokens, beam_search kwargs)
CASES = {
    # exhaustive: 16 beams over a vocab of 4
    "beams_exceed_vocab": (dict(vocab_size=4, batchsize=1, seed=3),
                           [[1, 2]], 3, dict(num_beams=16)),
    "length_penalty_eos": (dict(vocab_size=4, batchsize=1, seed=9),
                           [[3, 0]], 3,
                           dict(num_beams=16, length_penalty=1.0, eos_id=1,
                                max_len=7)),
    "batch_of_two": (dict(seed=7), np.random.default_rng(7).integers(
        0, VOCAB, (B, 5)), 6, dict(num_beams=4)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_beam_search_matches_jax(case):
    kw, prompt, n, beam = CASES[case]
    kw = dict(kw)
    nets = _nets(kw.pop("seed"), **kw)
    j, t = _both(nets, np.asarray(prompt, np.int32), n, **beam)
    assert t[0].shape == (len(prompt), n) and t[0].dtype == np.int64
    _assert_same(j, t)


def test_beam_ties_keep_the_lowest_index_as_jax():
    """C2: with a zero (tied) embedding every logit ties at every step;
    `jax.lax.top_k` then keeps the lowest token ids, and so must the
    port (`torch.topk` orders ties its own way)."""
    jnet, jp, tnet, tp = _nets(0)
    jp = {**jp, "embed/embedding": jnp.zeros_like(jp["embed/embedding"])}
    tp = {**tp, "embed/embedding": torch.zeros_like(tp["embed/embedding"])}
    j, t = _both((jnet, jp, tnet, tp), np.ones((B, 3), np.int32), 4,
                 num_beams=3)
    _assert_same(j, t)
    assert not t[0].any()


def test_beam_width_one_is_greedy_and_matches_jax():
    nets = _nets(0)
    prompt = np.random.default_rng(7).integers(0, VOCAB, (B, 5)).astype(
        np.int32)
    j, t = _both(nets, prompt, 6, num_beams=1)
    _assert_same(j, t)
    greedy = tgen.generate(nets[2], nets[3], prompt, 6)
    np.testing.assert_array_equal(t[0], greedy.numpy())


def test_beam_eos_freezes_and_matches_jax():
    nets = _nets(0)
    prompt = np.zeros((1, 4), np.int32)
    eos = int(tgen.generate(nets[2], nets[3], prompt, 1)[0, 0])
    j, t = _both(nets, prompt, 6, num_beams=2, eos_id=eos)
    _assert_same(j, t)
    row = t[0][0]
    assert eos in row
    assert (row[int(np.argmax(row == eos)):] == eos).all()


def test_beam_search_argument_checks():
    _, _, tnet, tp = _nets(0)
    prompt = torch.zeros((B, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="num_beams"):
        tgen.beam_search(tnet, tp, prompt, 3, num_beams=0)
    toks, scores = tgen.beam_search(tnet, tp, prompt, 0)
    assert toks.shape == (B, 0) and scores.shape == (B,)
    assert toks.dtype == torch.long and scores.dtype == torch.float32
    with pytest.raises(ValueError, match="max_len"):
        tgen.beam_search(tnet, tp, prompt, 8, max_len=10)
    for eos in (-1, VOCAB):
        with pytest.raises(ValueError, match="eos_id"):
            tgen.beam_search(tnet, tp, prompt, 3, eos_id=eos)


def test_moe_gqa_decode_matches_jax():
    """A MoE + GQA net (numpy weights): prefill logits, greedy tokens and
    beams against the JAX package's."""
    nets = _nets(5, jax_init=False, fused_head=True, moe_every=2,
                 num_experts=4, experts_per_token=2, num_kv_heads=2)
    jnet, jp, tnet, tp = nets
    toks = np.random.default_rng(5).integers(0, VOCAB, (B, SEQ)).astype(
        np.int32)
    jl, _ = jax.jit(lambda p, t, c: jgen.forward_cached(jnet, p, t, c, 0))(
        jp, jnp.asarray(toks), jgen.init_cache(jnet, B, SEQ))
    tl, _ = tgen.forward_cached(tnet, tp, torch.from_numpy(toks),
                                tgen.init_cache(tnet, B, SEQ,
                                                device="cpu"), 0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4,
                               atol=2e-4)
    want = jgen.generate(jnet, jp, jnp.asarray(toks[:, :4]), 6)
    got = tgen.generate(tnet, tp, torch.from_numpy(toks[:, :4]), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _assert_same(*_both(nets, toks[:, :4], 6, num_beams=3))
