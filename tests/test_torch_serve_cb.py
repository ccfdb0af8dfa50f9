"""Continuous batching in the port (`singa_tpu_torch/serve/`): the paged
decode, `scatter_prefill` and the engine's cb prefill and decode calls
held against the JAX package on the same pools, tables and weights,
then `ContinuousScheduler` against the JAX package's `generate` and
through the reference's scheduling cases (`tests/test_cb.py`): joins,
EOS retire and slot reuse, deadlines in the queue and mid-stream, and
pool exhaustion shed at admission.

A tiny LM (2 layers, E=32, 4 heads of 8, V=64, f32) with the same
numpy weights on both sides.  Tolerances: logits rtol/atol 1e-5; pools
1e-6 of their largest magnitude (a pool of a second layer holds K/V
projected from a residual stream that the two packages sum in different
orders: 1.2e-6 apart at most, 5 f32 ulps, where the largest entry is
about 5); pools that `scatter_prefill` only moves, exactly; tokens
exactly.  The null block (0) is left out of pool comparisons: inactive
slots and pad blocks all write it, no mask ever reads it, and which
duplicate write lands there is unspecified on both sides.  On the CPU
the engine calls its programs eagerly; the CUDA graphs they become on
the card are held against eager calls by `chip_smoke.py` phase 4.

A MoE net (kMoE in the second block, 4 experts, top-2) shares each
expert's capacity among all the rows of a call: at decode the slots are
the tokens, idle slots included (they feed token 0 at position 0, as
the reference's do), so a slot's answer depends on its neighbours and
cannot be held against `generate`.  It is held against the JAX
package's `forward_paged` and scheduler on the same inputs instead."""

import importlib
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.core.net import build_net as jbuild_net
from singa_tpu.models.transformer import transformer_lm as jtransformer_lm
from singa_tpu.serve.engine import InferenceEngine as JEngine
from singa_tpu.serve.engine import ServeSpec as JSpec
from singa_tpu.serve.kvcache import init_pools as jinit_pools
from singa_tpu.serve.scheduler import ContinuousScheduler as JScheduler

from singa_tpu_torch.core.net import build_net as tbuild_net
from singa_tpu_torch.models.transformer import \
    transformer_lm as ttransformer_lm
from singa_tpu_torch.serve import (ContinuousScheduler, DeadlineExpired,
                                   InferenceEngine, Overloaded, ServeSpec)
from singa_tpu_torch.weights import numpy_params, params_from_numpy

jgen = importlib.import_module("singa_tpu.models.generate")
tgen = importlib.import_module("singa_tpu_torch.models.generate")

from port_fixture import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.port
RTOL = ATOL = 1e-5
POOL_RTOL_OF_MAX = 1e-6
VOCAB, SEQ = 64, 16
CFG = dict(vocab_size=VOCAB, num_layers=2, embed_dim=32, num_heads=4,
           head_dim=8, seq_len=SEQ, batchsize=2)
SHAPES = {"data": {"input": (SEQ,), "target": (SEQ,)}}
QUIET = dict(log_fn=lambda s: None)


MOE = dict(moe_every=2, num_experts=4, experts_per_token=2)


def _nets(**kw):
    jnet = jbuild_net(jtransformer_lm(**CFG, **kw), "kTest", SHAPES)
    tnet = tbuild_net(ttransformer_lm(**CFG, **kw), "kTest", SHAPES)
    arrays = numpy_params(tnet, seed=0)
    jparams = {k: jnp.asarray(v) for k, v in arrays.items()}
    tparams = params_from_numpy(tnet, arrays, device="cpu")
    return jnet, jparams, tnet, tparams


@pytest.fixture(scope="module")
def nets():
    return _nets()


@pytest.fixture(scope="module")
def moe_nets():
    return _nets(**MOE)


def _random_pools(net, num_blocks, block_len, seed):
    """The same random (num_blocks, Hkv, block_len, D) pools on both
    sides: what earlier slots left behind."""
    rng = np.random.default_rng(seed)
    jp = jinit_pools(net[0], num_blocks, block_len)
    arrays = {n: {s: rng.standard_normal(e[s].shape).astype(np.float32)
                  for s in ("k", "v")} for n, e in jp.items()}
    return ({n: {s: jnp.asarray(a) for s, a in e.items()}
             for n, e in arrays.items()},
            {n: {s: torch.from_numpy(a.copy()) for s, a in e.items()}
             for n, e in arrays.items()})


def _assert_pools_close(tpools, jpools, tol=POOL_RTOL_OF_MAX):
    for name, entry in jpools.items():
        for side in ("k", "v"):
            want = np.asarray(entry[side])[1:]
            np.testing.assert_allclose(
                tpools[name][side][1:].numpy(), want, rtol=0,
                atol=tol * np.abs(want).max(), err_msg=f"{name}/{side}")


def test_forward_paged_matches_jax(nets):
    _check_forward_paged(nets)


def test_forward_paged_matches_jax_on_a_moe_net(moe_nets):
    """4 slots at capacity int(1.25 · 4 · 2 / 4) = 2 per expert: some
    assignments drop, and the idle slot's token joins the count."""
    _check_forward_paged(moe_nets)


def _check_forward_paged(nets):
    jnet, jparams, tnet, tparams = nets
    jpools, tpools = _random_pools(nets, 14, 4, seed=1)
    # slots 0-2 decode at positions 5, 9 and 2; slot 3 is inactive (its
    # table row and position all point at the null block)
    tables = np.array([[1, 2, 0], [3, 4, 5], [6, 0, 0], [0, 0, 0]], np.int32)
    ntoks = np.array([5, 9, 2, 0], np.int32)
    tokens = np.array([[7, 3, 60, 0]], np.int32)
    jl, jpools = jgen.forward_paged(jnet, jparams, jnp.asarray(tokens),
                                    jpools, jnp.asarray(tables),
                                    jnp.asarray(ntoks))
    tl, out = tgen.forward_paged(tnet, tparams, torch.from_numpy(tokens),
                                 tpools, torch.from_numpy(tables),
                                 torch.from_numpy(ntoks))
    assert out is tpools               # written in place
    np.testing.assert_allclose(tl[0, :3].numpy(), np.asarray(jl)[0, :3],
                               rtol=RTOL, atol=ATOL)
    _assert_pools_close(tpools, jpools)


def test_scatter_prefill_matches_jax(nets):
    jnet, _, tnet, _ = nets
    jpools, tpools = _random_pools(nets, 10, 4, seed=2)
    rng = np.random.default_rng(3)
    cache = {n: {s: rng.standard_normal((1, 4, 12, 8)).astype(np.float32)
                 for s in ("k", "v")} for n in jpools}
    row = np.array([7, 2, 0], np.int32)     # a 2-block slot, then null
    jpools = jgen.scatter_prefill(
        jpools, {n: {s: jnp.asarray(a) for s, a in e.items()}
                 for n, e in cache.items()}, jnp.asarray(row))
    out = tgen.scatter_prefill(
        tpools, {n: {s: torch.from_numpy(a) for s, a in e.items()}
                 for n, e in cache.items()}, torch.from_numpy(row))
    assert out is tpools
    _assert_pools_close(tpools, jpools, tol=0.0)
    np.testing.assert_array_equal(tpools["attn0"]["k"][2].numpy(),
                                  cache["attn0"]["k"][0, :, 4:8])


def test_cb_prefill_and_decode_calls_match_jax(nets):
    """The engine's two cb calls: a prefill into a slot's blocks, then
    decode steps with two active slots, on both engines from zeroed
    pools: the same greedy tokens and pools."""
    jnet, jparams, tnet, tparams = nets
    text = "buckets=2x16,max_new_tokens=8,cb=on,cb_slots=3,cb_block_len=4"
    jeng = JEngine(jnet, JSpec.parse(text), params=jparams, **QUIET)
    teng = InferenceEngine(tnet, ServeSpec.parse(text), tparams,
                           device="cpu", **QUIET)
    spec = teng.spec
    jpools = jinit_pools(jnet, spec.cb_pool_blocks, spec.cb_block_len)
    tpools = teng.cb_pools
    rng = np.random.default_rng(4)
    p_len, nb = spec.cb_prefill_len, spec.cb_prefill_len // 4
    tables = np.zeros((3, spec.cb_blocks_per_slot), np.int32)
    last = np.zeros((3,), np.int32)
    ntoks = np.zeros((3,), np.int32)
    for slot, plen, blocks in ((0, 5, [1, 2, 3]), (2, 11, [4, 5, 6, 7, 8])):
        toks = np.zeros((1, p_len), np.int32)
        toks[0, :plen] = rng.integers(1, VOCAB, plen)
        tables[slot, :len(blocks)] = blocks
        jt, jpools = jeng.run_cb_prefill(jparams, jpools, toks, plen,
                                         tables[slot, :nb])
        tt, _ = teng.run_cb_prefill(tparams, tpools, toks, plen,
                                    tables[slot, :nb])
        assert tt == jt
        last[slot], ntoks[slot] = tt, plen
    _assert_pools_close(tpools, jpools)
    for _ in range(4):
        jn, jpools = jeng.run_cb_decode(jparams, jpools, last, ntoks, tables)
        tn, _ = teng.run_cb_decode(tparams, tpools, last, ntoks, tables)
        np.testing.assert_array_equal(tn[[0, 2]], np.asarray(jn)[[0, 2]])
        last[[0, 2]] = tn[[0, 2]]
        ntoks[[0, 2]] += 1
    _assert_pools_close(tpools, jpools)


# -- the scheduler -----------------------------------------------------------

def _scheduler(tnet, tparams, **kw):
    spec = ServeSpec(**{**dict(buckets=((2, SEQ),), max_new_tokens=32,
                               request_timeout_s=30.0, cb="on",
                               cb_slots=4, cb_block_len=4), **kw})
    engine = InferenceEngine(tnet, spec, tparams, device="cpu", **QUIET)
    return ContinuousScheduler(engine, **QUIET).start()


def test_paged_greedy_matches_contiguous_and_jax(nets):
    """Prompt lengths 1, 5, 9 and 16 admitted together share decode
    steps, and each decodes to the port's contiguous-cache `generate`
    and to the JAX package's `generate` (`tests/test_cb.py:120`)."""
    jnet, jparams, tnet, tparams = nets
    sched = _scheduler(tnet, tparams)
    try:
        rng = np.random.default_rng(0)
        prompts = [rng.integers(1, VOCAB, n).astype(np.int32)
                   for n in (1, 5, 9, SEQ)]
        tickets = [sched.submit(p) for p in prompts]
        outs = [t.wait(60.0) for t in tickets]
    finally:
        sched.stop()
    for p, out in zip(prompts, outs):
        port = tgen.generate(tnet, tparams, p[None], 32)[0].tolist()
        ref = np.asarray(jgen.generate(jnet, jparams, jnp.asarray(p[None]),
                                       32))[0].tolist()
        assert out["tokens"] == port == ref, p.size
        assert out["finish"] == "length"
    assert sched.stats.snapshot()["failed"] == 0


def test_moe_scheduler_matches_jax_scheduler(moe_nets):
    """Six requests through 3 slots of a MoE net (capacity 1 per expert
    at decode), submitted before `start()` so that admission runs in
    one order on both sides: slots join, retire and sit idle in the
    same steps, and every answer equals the JAX scheduler's token for
    token.  Each request's deadline is the test's own 60 s wait: the
    spec's default of 5 s runs from `submit`, before the JAX side
    compiles its programs in the loop, and on a loaded machine that
    compile alone outlasted it (requests retired with "deadline")."""
    jnet, jparams, tnet, tparams = moe_nets
    text = ("buckets=2x16,max_new_tokens=12,cb=on,cb_slots=3,cb_block_len=4,"
            "request_timeout_s=60")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, VOCAB, n).astype(np.int32)
               for n in (1, 5, 9, SEQ, 3, 7)]
    max_new = [12, 4, 7, 12, 5, 9]
    scheds = (JScheduler(JEngine(jnet, JSpec.parse(text), params=jparams,
                                 **QUIET), **QUIET),
              ContinuousScheduler(InferenceEngine(
                  tnet, ServeSpec.parse(text), tparams, device="cpu",
                  **QUIET), **QUIET))
    answers = []
    for sched in scheds:
        tickets = [sched.submit(p, max_new=m)
                   for p, m in zip(prompts, max_new)]
        sched.start()
        try:
            answers.append([t.wait(60.0)["tokens"] for t in tickets])
        finally:
            sched.stop()
    assert answers[1] == answers[0]
    assert [len(a) for a in answers[1]] == max_new


def test_short_joins_and_finishes_while_long_decodes(nets):
    _, _, tnet, tparams = nets
    sched = _scheduler(tnet, tparams)
    try:
        long_t = sched.submit(np.array([3, 1, 4], np.int32))
        assert isinstance(next(long_t.tokens(timeout=30.0)), int)
        short = sched.submit(np.array([7, 7], np.int32), max_new=2)
        out = short.wait(30.0)
        assert len(out["tokens"]) == 2 and out["finish"] == "length"
        assert not long_t.done(), "short finished only after the long one"
        out = long_t.wait(60.0)
        assert len(out["tokens"]) == 32 and out["finish"] == "length"
    finally:
        sched.stop()


def test_eos_retires_slot_mid_batch_and_slot_is_reused(nets):
    _, _, tnet, tparams = nets
    probe = np.array([3, 1, 4], np.int32)
    ref = tgen.generate(tnet, tparams, probe[None], 8)[0].tolist()
    eos = ref[3]
    expected = ref[:ref.index(eos) + 1]
    other = np.array([9, 2, 5, 11], np.int32)
    oref = tgen.generate(tnet, tparams, other[None], 8, eos_id=eos)[0]
    oref = oref.tolist()
    if eos in oref:
        oref = oref[:oref.index(eos) + 1]
    sched = _scheduler(tnet, tparams, max_new_tokens=8, eos_id=eos,
                       cb_slots=2)
    try:
        t1, t2 = sched.submit(probe), sched.submit(other)
        out1, out2 = t1.wait(30.0), t2.wait(30.0)
        assert out1["finish"] == "eos" and out1["tokens"] == expected
        assert out2["tokens"] == oref
        out3 = sched.submit(probe).wait(30.0)     # the freed slot admits
        assert out3["tokens"] == expected and out3["finish"] == "eos"
    finally:
        sched.stop()


@pytest.fixture(scope="module")
def small(nets):
    """Pool of 40 blocks: one worst-case request (36 blocks) fits, two
    cannot coexist.  One full run (128 tokens) first; its wall time
    rides along."""
    _, _, tnet, tparams = nets
    sched = _scheduler(tnet, tparams, max_new_tokens=128, queue_capacity=2,
                       cb_slots=2, cb_blocks=40)
    t0 = time.monotonic()
    out = sched.submit(np.array([1, 2, 3], np.int32)).wait(60.0)
    assert len(out["tokens"]) == 128
    yield sched, time.monotonic() - t0
    sched.stop()


class _StepClock:
    """The scheduler module's `time`, with a `monotonic` that stands
    still but for one second per decode step: a deadline then falls on
    a decode step by construction, however loaded the host is (a
    deadline of a third of a calibration run's wall time did not: a
    run calibrated under load and served without it finished all 128
    tokens with `length`)."""

    def __init__(self):
        self.now = time.monotonic()

    def monotonic(self) -> float:
        return self.now

    def __getattr__(self, name):
        return getattr(time, name)


def test_deadline_mid_stream_retires_with_partial_result(small,
                                                         monkeypatch):
    sched, _ = small
    clock = _StepClock()
    decode = sched.engine.run_cb_decode

    def stepped(*args, **kwargs):
        out = decode(*args, **kwargs)
        clock.now += 1.0
        return out
    monkeypatch.setattr(importlib.import_module(
        "singa_tpu_torch.serve.scheduler"), "time", clock)
    monkeypatch.setattr(sched.engine, "run_cb_decode", stepped)
    # the prefill's token, then decode steps until the clock passes the
    # deadline: after the 11th, at 11 s > 10.5 s
    out = sched.submit(np.array([4, 5], np.int32),
                       deadline=clock.now + 10.5).wait(60.0)
    assert out["finish"] == "deadline"
    assert 1 <= len(out["tokens"]) < 128
    assert len(out["tokens"]) == 12


def test_deadline_expires_in_queue_when_pool_is_held(small):
    sched, _ = small
    hog = sched.submit(np.array([6, 7, 8], np.int32))
    next(hog.tokens(timeout=30.0))        # the hog holds 33 of 39 blocks
    before = sched.stats.expired
    with pytest.raises(DeadlineExpired):
        sched.submit(np.array([9, 9, 9], np.int32), timeout=0.05).wait(30.0)
    assert sched.stats.expired == before + 1
    assert len(hog.wait(60.0)["tokens"]) == 128


def test_pool_exhaustion_sheds_at_admission_no_deadlock(small):
    sched, _ = small
    before = sched.stats.shed
    hog = sched.submit(np.array([1, 1, 1], np.int32))
    next(hog.tokens(timeout=30.0))
    small_out = sched.submit(np.array([5], np.int32), max_new=2).wait(30.0)
    assert len(small_out["tokens"]) == 2  # 6 free blocks still fit it
    q1 = sched.submit(np.array([2, 2, 2], np.int32))
    q2 = sched.submit(np.array([3, 3, 3], np.int32))
    with pytest.raises(Overloaded) as ei:
        sched.submit(np.array([4, 4, 4], np.int32))
    assert ei.value.retry_after > 0
    assert sched.stats.shed == before + 1
    for t in (hog, q1, q2):
        assert len(t.wait(120.0)["tokens"]) == 128


def test_seeded_sampling_is_reproducible(nets):
    """Sampled tokens cannot equal JAX's (Philox against threefry); they
    are held to reproducibility from the engine's seed."""
    _, _, tnet, tparams = nets
    runs = []
    for seed in (3, 3, 4):
        sched = _scheduler(tnet, tparams, temperature=0.8, top_k=50,
                           top_p=0.9, seed=seed)
        try:
            tickets = [sched.submit(np.array([5, n, 2], np.int32))
                       for n in range(1, 7)]
            runs.append([t.wait(60.0)["tokens"] for t in tickets])
        finally:
            sched.stop()
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]
    assert all(0 <= t < VOCAB for row in runs[0] for t in row)


def test_engine_graph_switch_and_capture_accounting(nets):
    """`graphs=True` needs the card; on the CPU the programs run eagerly,
    so warm-up captures nothing and `compiles` does not move."""
    _, _, tnet, tparams = nets
    spec = ServeSpec(buckets=((2, SEQ),), cb="on", cb_slots=2,
                     cb_block_len=4)
    with pytest.raises(ValueError, match="CUDA"):
        InferenceEngine(tnet, spec, tparams, device="cpu", graphs=True)
    eng = InferenceEngine(tnet, spec, tparams, device="cpu", **QUIET)
    assert eng.graphs is False
    assert eng.warmup(("generate", "predict")) == 0
    assert eng.stats.compiles == 0
    with pytest.raises(ValueError, match="unknown mode"):
        eng.warmup(("bogus",))
