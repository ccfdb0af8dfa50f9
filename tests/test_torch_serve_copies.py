"""The port's serving vocabulary held against the JAX package's: the
`ServeSpec` grammar and its derived continuous-batching geometry,
`PagedKVCache` bookkeeping and `pool_bytes`, the JAX-free modules the
port keeps its own copies of (`utils/faults.py`, `serve/qos.py`,
`serve/tenancy.py`, `serve/stats.py`), and decode on a kLMHead ->
kSoftmaxLoss net (`examples/transformer/lm_tiny.conf`), where
`forward_cached` must skip the loss layer as the reference does
(`singa_tpu/models/generate.py:146-147`).  Logits rtol/atol 1e-5."""

import dataclasses
import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import singa_tpu.config as jconfig
from singa_tpu.core.net import build_net as jbuild_net
from singa_tpu.serve import qos as jqos
from singa_tpu.serve.engine import ServeSpec as JSpec
from singa_tpu.serve.kvcache import PagedKVCache as JKV
from singa_tpu.serve.kvcache import pool_bytes as jpool_bytes
from singa_tpu.serve.stats import ServeStats as JStats
from singa_tpu.serve.tenancy import TenantRegistry as JTenants
from singa_tpu.utils import faults as jfaults

import singa_tpu_torch.config as tconfig
from singa_tpu_torch.core.net import build_net as tbuild_net
from singa_tpu_torch.serve import qos as tqos
from singa_tpu_torch.serve.engine import ServeSpec
from singa_tpu_torch.serve.kvcache import PagedKVCache, init_pools, pool_bytes
from singa_tpu_torch.serve.stats import ServeStats
from singa_tpu_torch.serve.tenancy import TenantRegistry
from singa_tpu_torch.utils import faults as tfaults
from singa_tpu_torch.weights import numpy_params, params_from_numpy

jgen = importlib.import_module("singa_tpu.models.generate")
tgen = importlib.import_module("singa_tpu_torch.models.generate")

from port_fixture import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.port
RTOL = ATOL = 1e-5
LM_TINY = os.path.join(os.path.dirname(__file__), "..", "examples",
                       "transformer", "lm_tiny.conf")
SHAPES = {"data": {"input": (16,), "target": (16,)}}
DERIVED = ("cb_on", "cb_prefill_len", "cb_max_prompt_len",
           "cb_blocks_per_slot", "cb_pool_blocks", "max_prompt_len",
           "max_batch")


@pytest.mark.parametrize("text", [
    # the spec strings of tests/test_cb.py:53-73
    "buckets=4x16,max_new_tokens=8,cb=on,cb_slots=4,cb_block_len=4",
    "buckets=4x16",
    "buckets=4x16,max_new_tokens=8,cb=on,cb_block_len=4,cb_prompt_cap=6",
    # every other field, and the str branch
    "buckets=1x8/8x32;queue_capacity=7,batch_window_s=0.02,"
    "request_timeout_s=2.5,reload_poll_s=3,degraded_after=2,"
    "stall_fault_s=0.1,brownout_be_frac=0.25,brownout_batch_frac=0.5,"
    "family=LM-Tiny,flush_tokens=4,flush_ms=1.5,eos_id=none,pad_id=3,"
    "cb=ON,cb_blocks=90,seed=9,top_p=0.9,top_k=5,temperature=0.7",
])
def test_serve_spec_parses_like_jax(text):
    j, t = JSpec.parse(text), ServeSpec.parse(text)
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(j)]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for prop in DERIVED:
        assert getattr(t, prop) == getattr(j, prop), prop


@pytest.mark.parametrize("text", [
    "cb=maybe", "cb=on,cb_slots=0", "cb_block_len=0", "cb_blocks=-1",
    "queue_capacity=0", "degraded_after=0", "stall_fault_s=-1",
    "brownout_be_frac=0.8,brownout_batch_frac=0.5", "family= ",
    "flush_tokens=0", "flush_ms=-1", "max_new_tokens=0", "bogus=1",
    "buckets=0x8",
])
def test_serve_spec_rejects_like_jax(text):
    with pytest.raises(ValueError):
        JSpec.parse(text)
    with pytest.raises(ValueError):
        ServeSpec.parse(text)


@pytest.fixture(scope="module")
def tiny():
    """lm_tiny.conf in both packages with the same numpy weights."""
    jnet = jbuild_net(jconfig.load_model_config(LM_TINY), "kTest", SHAPES)
    tnet = tbuild_net(tconfig.load_model_config(LM_TINY), "kTest", SHAPES)
    arrays = numpy_params(tnet, seed=0)
    return (jnet, {k: jnp.asarray(v) for k, v in arrays.items()}, tnet,
            params_from_numpy(tnet, arrays, device="cpu"))


def test_kvcache_bookkeeping_matches_jax(tiny):
    """One sequence of alloc and free calls on both caches: the same
    tables, counts and snapshots after every call."""
    jnet, _, tnet, _ = tiny
    j = JKV(jnet, num_slots=3, max_blocks_per_slot=4, num_blocks=9,
            block_len=4, dtype=np.float32)
    t = PagedKVCache(tnet, num_slots=3, max_blocks_per_slot=4, num_blocks=9,
                     block_len=4, device="cpu")
    for op, slot, n in (("alloc", 0, 2), ("alloc", 1, 4), ("free", 0, 0),
                        ("alloc", 2, 3), ("alloc", 0, 1), ("free", 1, 0),
                        ("free", 1, 0), ("alloc", 1, 4), ("free", 2, 0)):
        if op == "alloc":
            np.testing.assert_array_equal(t.alloc(slot, n), j.alloc(slot, n))
        else:
            t.free(slot)
            j.free(slot)
        np.testing.assert_array_equal(t.table_array(), j.table_array())
        assert t.snapshot() == j.snapshot()
        assert [t.blocks_for(k) for k in (1, 4, 5, 17)] == \
            [j.blocks_for(k) for k in (1, 4, 5, 17)]
        assert t.can_admit(2) == j.can_admit(2)
    for cache in (t, j):
        with pytest.raises(RuntimeError, match="exhausted"):
            cache.alloc(2, 4)
    t.free_all()
    assert t.free_blocks == 8 and t.blocks_in_use == 0
    with pytest.raises(ValueError):
        PagedKVCache(tnet, 1, 1, 1, 4, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_bytes_matches_jax_and_the_allocation(tiny, dtype):
    jnet, _, tnet, _ = tiny
    tdt = getattr(torch, dtype)
    got = pool_bytes(tnet, 37, 16, tdt)
    assert got == jpool_bytes(jnet, 37, 16, getattr(jnp, dtype))
    pools = init_pools(tnet, 37, 16, tdt, "cpu")
    assert got == sum(t.numel() * t.element_size()
                      for e in pools.values() for t in e.values())
    adopted = PagedKVCache(tnet, 2, 4, 37, 16, device="cpu", pools=pools)
    assert adopted.pools is pools
    with pytest.raises(ValueError, match="not"):
        PagedKVCache(tnet, 2, 4, 36, 16, device="cpu", pools=pools)


def test_backoff_and_fault_schedule_match_jax():
    jb, tb = jfaults.Backoff(base=0.05, cap=2.0, seed=7), \
        tfaults.Backoff(base=0.05, cap=2.0, seed=7)
    assert [tb.delay(k) for k in range(8)] == [jb.delay(k) for k in range(8)]
    spec = "serve.admit@1,engine.stall@0:stall,serve.batch@2"
    js = jfaults.FaultSchedule.parse(spec, seed=3)
    ts = tfaults.FaultSchedule.parse(spec, seed=3)
    for site in ("serve.admit", "engine.stall", "serve.batch") * 3:
        outs = []
        for sch in (js, ts):
            try:
                outs.append(sch.visit(site))
            except RuntimeError as e:
                outs.append(type(e).__name__)
        assert outs[0] == outs[1], site
    assert tfaults.SITES == jfaults.SITES
    with tfaults.inject(ts):
        assert tfaults.maybe_fault("serve.admit") is None
    assert tfaults.maybe_fault("serve.admit") is None


def test_class_backoffs_and_deadlines_match_jax():
    jc = jqos.ClassBackoffs(base=0.05, cap=2.0, seed=1)
    tc = tqos.ClassBackoffs(base=0.05, cap=2.0, seed=1)
    for prio in ("interactive", "batch", "best_effort", "batch"):
        assert tc.shed_delay(prio, tenant="a") == \
            jc.shed_delay(prio, tenant="a")
    assert tqos.PRIORITIES == jqos.PRIORITIES
    assert tqos.resolve_deadline(None, 12.5, 5.0) == \
        jqos.resolve_deadline(None, 12.5, 5.0) == 12.5


def test_tenant_quotas_match_jax():
    text = "a,queue_frac=0.25,slot_frac=0.5,kv_frac=0.3,budget_floor=4;" \
           "b,queue_frac=0.5,brownout_be_frac=0.2"
    j, t = JTenants.parse(text), TenantRegistry.parse(text)
    for tenant in ("a", "b", "default", "unknown-7", None):
        assert t.label(tenant) == j.label(tenant)
        assert t.queue_quota(tenant, 64) == j.queue_quota(tenant, 64)
        assert t.slot_quota(tenant, 32) == j.slot_quota(tenant, 32)
        assert t.kv_quota(tenant, 1280) == j.kv_quota(tenant, 1280)
        assert t.brownout_fracs(tenant, 0.5, 0.75) == \
            j.brownout_fracs(tenant, 0.5, 0.75)
    assert t.snapshot() == j.snapshot()


def test_serve_stats_snapshot_matches_jax():
    """The same observations give the same snapshot, but for the fields
    that read the clock (rates over the object's lifetime)."""
    snaps = []
    for stats in (JStats(), ServeStats()):
        stats.count("submitted", 5)
        stats.count("compiles", 2)
        stats.count("shed")
        stats.gauge("queue_depth", 3)
        stats.gauge("cb_blocks_total", 1280)
        for i in range(5):
            stats.observe_latency(0.01 * (i + 1))
            stats.observe_request(0.001 * i, 0.01 * (i + 1), 8 + i)
            stats.tenants.count("completed", "default")
            stats.tenants.observe_latency(0.01 * (i + 1), "default")
        stats.observe_batch(3, 4)
        stats.observe_batch_failure()
        for active in (4, 2, 1):
            stats.observe_cb_step(active, 100 * active)
        stats.gauge("cb_slot_capacity", 4)
        snap = stats.snapshot()
        for key in ("qps", "qps_recent", "uptime_s",
                    "cb_slot_occupancy_recent"):
            snap.pop(key)
        snaps.append(snap)
    assert snaps[1] == snaps[0]


def test_forward_cached_skips_the_softmax_loss(tiny, monkeypatch):
    """R1: on a kLMHead -> kSoftmaxLoss net decode never calls the loss
    layer, reads sources through `_src_out`, and gives the reference's
    logits at prefill and at a decode step."""
    jnet, jparams, tnet, tparams = tiny
    loss = tnet.layers["loss"]
    assert loss.cfg.type == "kSoftmaxLoss"

    def boom(*a, **k):
        raise AssertionError("decode ran the kSoftmaxLoss layer")
    monkeypatch.setattr(loss, "apply", boom)
    seen = []
    real = tnet._src_out

    def spy(outputs, src, dst):
        seen.append(dst)
        return real(outputs, src, dst)
    monkeypatch.setattr(tnet, "_src_out", spy)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, 64, (2, 6)).astype(np.int32)
    nxt = rng.integers(0, 64, (2, 1)).astype(np.int32)
    jc = jgen.init_cache(jnet, 2, 8)
    tc = tgen.init_cache(tnet, 2, 8, device="cpu")
    for toks, pos in ((prompt, 0), (nxt, 6)):
        jl, jc = jgen.forward_cached(jnet, jparams, jnp.asarray(toks), jc,
                                     pos)
        tl, tc = tgen.forward_cached(tnet, tparams, torch.from_numpy(toks),
                                     tc, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                                   atol=ATOL)
    assert "lm_head" in seen and "loss" in seen
    want = np.asarray(jgen.generate(jnet, jparams, jnp.asarray(prompt), 5))
    got = tgen.generate(tnet, tparams, prompt, 5)
    np.testing.assert_array_equal(got.numpy(), want)


def test_forward_cached_takes_tensors_only(tiny):
    """Token inputs are tensors already on the params' device: a copy
    from host memory inside the call could not be captured."""
    _, _, tnet, tparams = tiny
    cache = tgen.init_cache(tnet, 1, 4, device="cpu")
    with pytest.raises(TypeError, match="tensor"):
        tgen.forward_cached(tnet, tparams, np.zeros((1, 2), np.int32),
                            cache, 0)
