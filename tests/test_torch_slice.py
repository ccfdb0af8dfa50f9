"""The PyTorch port's inference slice against the JAX package, in f32 on
the CPU: the copied config parser, the scoring forward (loss, precision
and every attention layer's output on the packed flash route), KV-cache
`forward_cached` with and without the left-pad mask, greedy `generate`,
and the engine's predict bucket.

One transformer_lm call builds both nets; the JAX params go to the port
through `weights.params_from_numpy`.  Tolerances: loss rtol 1e-5 and
precision exact (f32 sums in another order cannot move a hit at this
size); activations and logits rtol 1e-4, atol 1e-5 (as
tests/test_sequence.py:45-46); greedy tokens equal."""

import glob
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import singa_tpu.config as jconfig
import singa_tpu.ops.attention as jattn
from singa_tpu.core.net import build_net as jbuild_net
from singa_tpu.models.transformer import synthetic_token_batches
from singa_tpu.models.transformer import transformer_lm as jtransformer_lm
from singa_tpu.serve.engine import _left_pad_mask as jleft_pad_mask

import singa_tpu_torch.config as tconfig
import singa_tpu_torch.ops.attention as tattn
from singa_tpu_torch.core.net import build_net as tbuild_net
from singa_tpu_torch.models.transformer import \
    transformer_lm as ttransformer_lm
from singa_tpu_torch.serve.engine import InferenceEngine, ServeSpec, left_pad
from singa_tpu_torch.weights import numpy_params, params_from_numpy

# the packages' models/__init__ re-export `generate`, shadowing the module
jgen = importlib.import_module("singa_tpu.models.generate")
tgen = importlib.import_module("singa_tpu_torch.models.generate")

from port_fixture import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.port
RTOL, ATOL = 1e-4, 1e-5
B, S, VOCAB = 4, 128, 2048
CFG = dict(vocab_size=VOCAB, num_layers=2, embed_dim=128, num_heads=4,
           num_kv_heads=2, head_dim=32, seq_len=S, batchsize=B)
SHAPES = {"data": {"input": (S,), "target": (S,)}}
EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


@pytest.fixture(scope="module")
def nets():
    jnet = jbuild_net(jtransformer_lm(**CFG), "kTrain", SHAPES)
    tnet = tbuild_net(ttransformer_lm(**CFG), "kTrain", SHAPES)
    jparams = jnet.init_params(jax.random.PRNGKey(0))
    tparams = params_from_numpy(
        tnet, {k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    return jnet, jparams, tnet, tparams


@pytest.mark.parametrize(
    "path", sorted(glob.glob(os.path.join(EXAMPLES, "**", "*.conf"),
                             recursive=True)))
def test_config_copy_parses_like_jax(path):
    kind = "cluster" if "cluster" in os.path.basename(path) else "model"
    load_j = getattr(jconfig, f"load_{kind}_config")
    load_t = getattr(tconfig, f"load_{kind}_config")
    assert tconfig.config_to_dict(load_t(path)) == \
        jconfig.config_to_dict(load_j(path))


def test_scoring_forward_matches_jax(nets, monkeypatch):
    jnet, jparams, tnet, tparams = nets
    routes = []

    def spy(mod, tag):
        real = mod.flash_attention_packed

        def wrapped(*a, **k):
            routes.append(tag)
            return real(*a, **k)
        monkeypatch.setattr(mod, "flash_attention_packed", wrapped)
    spy(jattn, "jax")
    spy(tattn, "port")

    batch = next(synthetic_token_batches(B, S, VOCAB, seed=3))
    _, jm, jout = jnet.apply(jparams, jax.tree_util.tree_map(jnp.asarray,
                                                             batch),
                             train=False)
    _, tm, tout = tnet.apply(tparams, batch, train=False)
    assert sorted(routes) == ["jax", "jax", "port", "port"]
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert float(tm["precision"]) == float(jm["precision"])
    for name in ("attn0", "attn1"):
        np.testing.assert_allclose(tout[name].numpy(),
                                   np.asarray(jout[name]),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("masked", [False, True])
def test_forward_cached_matches_jax(nets, masked):
    jnet, jparams, tnet, tparams = nets
    rng = np.random.default_rng(4)
    p, max_len = 16, 24
    prompt = rng.integers(0, VOCAB, (B, p)).astype(np.int32)
    nxt = rng.integers(0, VOCAB, (B, 1)).astype(np.int32)
    plens = np.array([16, 10, 5, 1], np.int32)
    jmask = (jleft_pad_mask(p, max_len, jnp.asarray(plens))
             if masked else None)
    tmask = torch.from_numpy(np.array(jmask)) if masked else None
    jc = jgen.init_cache(jnet, B, max_len)
    tc = tgen.init_cache(tnet, B, max_len, device="cpu")
    for toks, pos in ((prompt, 0), (nxt, p)):
        jl, jc = jgen.forward_cached(jnet, jparams, jnp.asarray(toks), jc,
                                     pos, kmask=jmask)
        tl, tc = tgen.forward_cached(tnet, tparams, torch.from_numpy(toks),
                                     tc, pos, kmask=tmask)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=RTOL, atol=ATOL)


def test_greedy_generate_matches_jax(nets):
    jnet, jparams, tnet, tparams = nets
    prompt = np.random.default_rng(5).integers(0, VOCAB, (2, 12)) \
        .astype(np.int32)
    want = np.asarray(jgen.generate(jnet, jparams, jnp.asarray(prompt), 8))
    got = tgen.generate(tnet, tparams, prompt, 8).numpy()
    np.testing.assert_array_equal(got, want)


def test_engine_predict_matches_jax_forward_cached(nets):
    jnet, jparams, tnet, tparams = nets
    rng = np.random.default_rng(6)
    prompts = [list(rng.integers(0, VOCAB, n)) for n in (16, 9, 3)]
    engine = InferenceEngine(tnet, ServeSpec(buckets=((4, 16),)), tparams,
                             device="cpu")
    tokens, plens = left_pad(prompts, (4, 16))
    got = engine.run_batch("predict", tokens, plens)
    cache = jgen.init_cache(jnet, 4, 17)
    logits, _ = jgen.forward_cached(
        jnet, jparams, jnp.asarray(tokens), cache, 0,
        kmask=jleft_pad_mask(16, 17, jnp.asarray(plens)))
    want = jax.nn.log_softmax(logits[:, -1], axis=-1)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_engine_generate_matches_unpadded_generate(nets):
    _, _, tnet, tparams = nets
    rng = np.random.default_rng(7)
    prompts = [list(rng.integers(0, VOCAB, n)) for n in (12, 7)]
    engine = InferenceEngine(tnet, ServeSpec(buckets=((2, 12),),
                                             max_new_tokens=5),
                             tparams, device="cpu")
    got = engine.answer("generate", prompts)
    for row, prompt in zip(got, prompts):
        want = tgen.generate(tnet, tparams, np.array([prompt]), 5)[0]
        np.testing.assert_array_equal(row, want.numpy())


def test_params_from_numpy_checks_names_and_shapes(nets):
    _, _, tnet, _ = nets
    arrays = numpy_params(tnet, seed=1)
    assert set(params_from_numpy(tnet, arrays, device="cpu")) == \
        set(tnet.param_specs)
    bad = dict(arrays)
    bad.pop("attn0/wq")
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(tnet, bad, device="cpu")
    with pytest.raises(ValueError, match="unexpected"):
        params_from_numpy(tnet, {**arrays, "extra/w": arrays["attn0/wq"]},
                          device="cpu")
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(tnet, {**arrays, "attn0/wq": arrays["attn0/wk"]},
                          device="cpu")


def test_sampling_filters_and_eos(nets):
    """top-k=1 and a vanishing nucleus sample the greedy token; after
    eos a row keeps emitting eos (generate.py:294-349 semantics)."""
    _, _, tnet, tparams = nets
    prompt = np.random.default_rng(8).integers(0, VOCAB, (2, 6))
    greedy = tgen.generate(tnet, tparams, prompt, 6)
    for kw in ({"top_k": 1}, {"top_p": 1e-6}):
        gen = torch.Generator().manual_seed(1)
        got = tgen.generate(tnet, tparams, prompt, 6, gen, temperature=0.7,
                            **kw)
        assert torch.equal(got, greedy), kw
    eos = int(greedy[0, 0])
    got = tgen.generate(tnet, tparams, prompt, 6, eos_id=eos)
    assert (got[0] == eos).all()
    with pytest.raises(ValueError, match="max_len"):
        tgen.generate(tnet, tparams, prompt, 6, max_len=8)


def test_serve_spec_matches_jax():
    from singa_tpu.serve.engine import ServeSpec as JServeSpec
    text = "buckets=4x16/1x8/8x32,max_new_tokens=8,eos_id=2,top_k=5"
    j, t = JServeSpec.parse(text), ServeSpec.parse(text)
    assert t.buckets == j.buckets and t.eos_id == j.eos_id == 2
    assert (t.max_new_tokens, t.top_k) == (j.max_new_tokens, j.top_k)
    for n, plen in [(1, 3), (3, 9), (5, 16), (9, 20), (2, 32)]:
        assert t.bucket_for(n, plen) == j.bucket_for(n, plen)
    with pytest.raises(ValueError):
        ServeSpec.parse("bogus=1")


@pytest.mark.parametrize("method", ["kConstant", "kUniform",
                                    "kGaussain", "kXavier", "kMSRA"])
def test_init_distributions_match_jax(method):
    """The same init methods draw from the same distributions (values
    differ: a JAX key and a torch.Generator are different streams)."""
    from singa_tpu.config.schema import ParamConfig as JParamConfig
    from singa_tpu.core.init import init_param as jinit
    from singa_tpu_torch.config.schema import ParamConfig as TParamConfig
    from singa_tpu_torch.core.init import init_param as tinit
    kw = dict(init_method=method, value=2.0, low=-0.5, high=1.5, mean=0.3,
              std=0.7)
    shape, fan_in = (200, 300), 150
    j = np.asarray(jinit(jax.random.PRNGKey(0), JParamConfig(**kw), shape,
                         fan_in))
    t = tinit(torch.Generator().manual_seed(0), TParamConfig(**kw), shape,
              fan_in).numpy()
    assert t.shape == j.shape and t.dtype == j.dtype
    np.testing.assert_allclose(t.mean(), j.mean(), atol=0.02 * j.std() + 1e-6)
    np.testing.assert_allclose(t.std(), j.std(), rtol=0.02, atol=1e-6)
