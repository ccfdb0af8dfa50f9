"""The port's elastic tier (`singa_tpu_torch/parallel/elastic.py`) and
the trainer's and the CLI's use of it, against the JAX package's
(`singa_tpu/parallel/elastic.py`), in f32 on the CPU.

The same numpy inputs go through both: the EASGD exchange and the
scalar helpers; RandomSync's mask application on the masks JAX draws
(Threefry is not reproduced, so the port's own draw is held to its
ratio and its seed instead); the controller inside `Trainer.run` on a
narrowed copy of the shipped `examples/mnist/mlp.conf` (784-64-32-10,
batch 32, warmup 4, a sync every 2 steps, lr 0.1), from the same weights (`weights.py`), params held after every
sync step; the chunk cuts; poisoned and skipped rounds under the
`sync.delta` and `sync.elastic` faults; `ReplicaSet` with 2 groups; and
the CLI past the warmup, alone and with 2 async worker groups.

Tolerances: the exchanges alone atol 1e-6 (the same f32 operations);
params after training steps rtol 1e-5, atol 1e-6 (the products may sum
in another order)."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.config import model_config_from_text as jconfig
from singa_tpu.config.schema import UpdaterConfig as JUpdaterConfig
from singa_tpu.core.trainer import Trainer as JTrainer
from singa_tpu.data.synthetic import synthetic_image_batches
from singa_tpu.main import main as jmain
from singa_tpu.parallel import elastic as jel
from singa_tpu.utils import faults as jfaults

import singa_tpu_torch.main as tmain
from singa_tpu_torch.config import model_config_from_text as tconfig
from singa_tpu_torch.config.schema import UpdaterConfig as TUpdaterConfig
from singa_tpu_torch.core.trainer import Trainer
from singa_tpu_torch.parallel import elastic as tel
from singa_tpu_torch.utils import faults as tfaults
from singa_tpu_torch.weights import opt_state_from_numpy, params_from_numpy

from port_fixture import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.port
MLP = "examples/mnist/mlp.conf"
SHAPES = {"data": {"pixel": (28, 28), "label": ()}}
ATOL = 1e-6
RTOL_TRAIN, ATOL_TRAIN = 1e-5, 1e-6


def _tree(rng, scale=1.0):
    return {"fc1/weight": (scale * rng.standard_normal((6, 5))
                           ).astype(np.float32),
            "fc1/bias": (scale * rng.standard_normal(5)).astype(np.float32)}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _close(got, want, rtol=0.0, atol=ATOL):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=rtol, atol=atol, err_msg=k)


# -- the exchanges and the helpers ----------------------------------------

def test_elastic_update_matches_jax():
    rng = np.random.default_rng(0)
    r, c = _tree(rng), _tree(rng)
    jr, jc = jel.elastic_update(_j(r), _j(c), 0.45)
    tr, tc = tel.elastic_update(_t(r), _t(c), 0.45)
    _close(tr, jr)
    _close(tc, jc)


def test_randomsync_apply_on_the_masks_jax_draws():
    rng = np.random.default_rng(1)
    r, c, s = _tree(rng), _tree(rng), _tree(rng)
    key = jax.random.PRNGKey(3)
    jr, jc, js = jel.randomsync_update(_j(r), _j(c), _j(s), 0.3, key)
    # the masks randomsync_update draws: one key per leaf, leaves in
    # the dict's sorted key order
    leaves, _ = jax.tree_util.tree_flatten(_j(r))
    keys = jax.random.split(key, len(leaves))
    names = sorted(r)
    masks = {n: np.asarray((jax.random.uniform(k, leaf.shape) < 0.3
                            ).astype(leaf.dtype))
             for n, k, leaf in zip(names, keys, leaves)}
    assert 0 < sum(m.sum() for m in masks.values()) < 35
    tr, tc, ts = tel.randomsync_apply(_t(r), _t(c), _t(s), _t(masks))
    _close(tr, jr)
    _close(tc, jc)
    _close(ts, js)


def test_randomsync_masks_sample_their_ratio_from_their_seed():
    big = {"w": torch.zeros(20_000)}
    m1 = tel.randomsync_masks(big, 0.3, tel.mask_generator(7, "cpu"))
    m2 = tel.randomsync_masks(big, 0.3, tel.mask_generator(7, "cpu"))
    m3 = tel.randomsync_masks(big, 0.3, tel.mask_generator(8, "cpu"))
    assert torch.equal(m1["w"], m2["w"]) and not torch.equal(m1["w"],
                                                             m3["w"])
    assert 0.28 < float(m1["w"].mean()) < 0.32
    assert set(m1["w"].unique().tolist()) == {0.0, 1.0}


@pytest.mark.parametrize("args", [
    (100, 1, 50, 1_000_000, 1.0), (1e9, 1, 1, 1000, 1.0),
    (100, 1, 1, 0, 1.0), (0.3, 2, 3, 250_000, 0.5), (100, 1, 2, 10, 0.0)])
def test_sync_sample_ratio_matches_jax(args):
    assert tel.sync_sample_ratio(*args) == jel.sync_sample_ratio(*args)


@pytest.mark.parametrize("knobs", [
    dict(param_type="Elastic", moving_rate=0.9, sync_frequency=8,
         warmup_steps=60),
    dict(param_type="Elastic", moving_rate=0.0, sync_frequency=8,
         warmup_steps=60),
    dict(param_type="RandomSync", moving_rate=0.0, sync_frequency=3,
         warmup_steps=2),
    dict(param_type="Elastic", moving_rate=0.6, sync_frequency=0,
         warmup_steps=0),
])
def test_cadence_alpha_and_activation_match_jax(knobs):
    kw = dict(type="kSGD", base_learning_rate=0.1, **knobs)
    jc, tc = JUpdaterConfig(**kw), TUpdaterConfig(**kw)
    assert tel.async_active(tc) == jel.async_active(jc)
    assert tel.async_active(None) == jel.async_active(None) is False
    for g in (1, 2, 3):
        assert tel.easgd_alpha(tc, g) == jel.easgd_alpha(jc, g)
    assert ([s for s in range(120) if tel.sync_now(tc, s)]
            == [s for s in range(120) if jel.sync_now(jc, s)])


# -- the controller under faults ------------------------------------------

@pytest.mark.parametrize("spec,cap,poisoned,skipped", [
    ("sync.delta@2:nan", 0.0, 1, 0),
    ("sync.delta@1:spike", 50.0, 1, 0),
    ("sync.delta@2:spike", 0.0, 0, 0),
    ("sync.elastic@2:error,sync.elastic@3:error,sync.elastic@4:error",
     0.0, 0, 1),
])
def test_poisoned_and_skipped_rounds_count_as_jax(spec, cap, poisoned,
                                                  skipped):
    kw = dict(type="kSGD", base_learning_rate=0.1, param_type="Elastic",
              moving_rate=0.8, sync_frequency=1, warmup_steps=1)
    quiet = lambda s: None  # noqa: E731
    jc = jel.ElasticController(JUpdaterConfig(**kw), 2, log_fn=quiet,
                               delta_max_norm=cap,
                               sync_backoff=jfaults.Backoff(base=0.0))
    tc = tel.ElasticController(TUpdaterConfig(**kw), 2, log_fn=quiet,
                               delta_max_norm=cap,
                               sync_backoff=tfaults.Backoff(base=0.0))
    jp = _drive(jc, jfaults, spec, _j)
    tp = _drive(tc, tfaults, spec, _t)
    assert (tc.poisoned_rounds, tc.skipped_rounds) == \
        (jc.poisoned_rounds, jc.skipped_rounds) == (poisoned, skipped)
    _close(tc.center, jc.center, rtol=1e-6, atol=1e-5)
    _close(tp, jp, rtol=1e-6, atol=1e-5)


def _drive(ctl, faults, spec, to_tree):
    """Six steps of one replica's params (noise added after each) through
    `ctl.maybe_sync` under the fault schedule `spec`."""
    rng = np.random.default_rng(2)
    p = _tree(rng)
    with faults.inject(faults.FaultSchedule.parse(spec, seed=0)):
        for s in range(6):
            p = {k: np.array(v) for k, v in
                 ctl.maybe_sync(s, to_tree(p)).items()}
            noise = _tree(rng, 0.1)
            p = {k: p[k] + noise[k] for k in p}
    return p


# -- the trainer -----------------------------------------------------------

def _mlp_text(param_type="Elastic", steps=20, lr=0.1, momentum=None):
    """mlp.conf narrowed to 784-64-32-10: fc3-fc5 and their tanh layers
    left out (fc6 reads tanh2), the widths and batch cut, the cadence
    shortened and the rate raised; init, activations and loss as
    shipped."""
    with open(MLP) as f:
        head, *layers = re.split(r"(?m)^  layer \{\n", f.read())
    text = head + "".join("  layer {\n" + body for body in layers
                          if not re.search(r'name: "(fc|tanh)[345]"', body))
    for a, b in (("2500", "64"), ("2000", "32")):
        text = re.sub(rf"num_output: {a}\b", f"num_output: {b}", text)
    text = (text.replace('srclayers: "tanh5"', 'srclayers: "tanh2"')
            .replace("batchsize: 1000", "batchsize: 32")
            .replace("warmup_steps: 60", "warmup_steps: 4")
            .replace("sync_frequency: 8", "sync_frequency: 2")
            .replace("base_learning_rate: 0.001",
                     f"base_learning_rate: {lr}"))
    text = re.sub(r"train_steps: \d+", f"train_steps: {steps}", text)
    text = re.sub(r"test_frequency: \d+", "test_frequency: 0", text)
    extra = f'  param_type: "{param_type}"\n'
    if momentum is not None:
        extra += f"  momentum: {momentum}\n"
    return text.replace("updater {\n", "updater {\n" + extra, 1)


def _trainers(text):
    jt = JTrainer(jconfig(text), SHAPES, log_fn=lambda s: None, donate=False)
    tt = Trainer(tconfig(text), SHAPES, log_fn=lambda s: None, device="cpu")
    return jt, tt


def _carried(jt, tt, seed=0):
    """JAX's init for both trainers: (jax params, opt, port params, opt)."""
    jp, jo = jt.init(seed=seed)
    tp = params_from_numpy(tt.train_net,
                           {k: np.asarray(v) for k, v in jp.items()},
                           device="cpu")
    to = opt_state_from_numpy(tt.train_net,
                              jax.tree_util.tree_map(np.asarray, jo),
                              device="cpu")
    return jp, jo, tp, to


def _record_syncs(trainer):
    """Params after every sync step of `trainer.run`, by step."""
    seen = {}
    ctl, orig = trainer.elastic, trainer.elastic.maybe_sync

    def wrapped(step, params, rng=None):
        out = orig(step, params, rng=rng)
        if ctl.sync_now(step):
            seen[step] = {k: np.array(v) for k, v in out.items()}
        return out
    ctl.maybe_sync = wrapped
    return seen


def _stream():
    return synthetic_image_batches(32, seed=11, stream_seed=50)


def test_controller_in_the_trainer_matches_jax_after_every_sync():
    jt, tt = _trainers(_mlp_text())
    assert jt.elastic is not None and tt.elastic is not None
    assert tt.elastic.alpha == jt.elastic.alpha == 0.9
    jp, jo, tp, to = _carried(jt, tt)
    jseen, tseen = _record_syncs(jt), _record_syncs(tt)
    jt.run(jp, jo, _stream(), seed=0)
    tp, _, _ = tt.run(tp, to, _stream(), seed=0)
    assert sorted(tseen) == sorted(jseen) == list(range(4, 20, 2))
    for s in jseen:
        _close(tseen[s], jseen[s], RTOL_TRAIN, ATOL_TRAIN)
    _close(tt.elastic.center, jt.elastic.center, RTOL_TRAIN, ATOL_TRAIN)
    # the exchanges moved the params: a plain run ends elsewhere
    jt0, tt0 = _trainers(_mlp_text().replace("moving_rate: 0.9",
                                             "moving_rate: 0.0"))
    assert tt0.elastic is None
    _, _, p0, o0 = _carried(jt0, tt0)
    p0, _, _ = tt0.run(p0, o0, _stream(), seed=0)
    assert max(float((p0[k] - tp[k]).abs().max()) for k in tp) > 1e-4


def test_chunks_are_cut_at_sync_steps_as_jax_cuts_them():
    """`tests/test_elastic.py:176`'s cadence: warmup 2, a sync every 3,
    10 steps, chunks of up to 8; the chunked run equals the per-step
    run bit for bit."""
    text = (_mlp_text(steps=10).replace("warmup_steps: 4", "warmup_steps: 2")
            .replace("sync_frequency: 2", "sync_frequency: 3"))
    jt, tt = _trainers(text)

    def plan(trainer):
        step, out = 0, []
        while step < 10:
            n = trainer._next_chunk_len(step, 8)
            out.append((step, n))
            step += n
        return out
    assert plan(tt) == plan(jt) == [(0, 3), (3, 3), (6, 3), (9, 1)]
    assert list(tt._chunk_plan(0, 8)) == plan(jt)
    runs = []
    for chunk in (0, 8):
        _, _, tp, to = _carried(jt, tt)
        tt.elastic.center = None
        tp, to, _ = tt.run(tp, to, _stream(), seed=0, scan_chunk=chunk,
                           feeder=False)
        runs.append(tp)
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k]), k


# -- ReplicaSet ------------------------------------------------------------

def _replica_sets(param_type, momentum=None, **kw):
    text = _mlp_text(param_type, momentum=momentum)
    jt, tt = _trainers(text)
    jrs = jel.ReplicaSet(jt, ngroups=2, seed=0, **kw)
    trs = tel.ReplicaSet(tt, ngroups=2, seed=0, **kw)
    # the JAX replicas' init, carried into the port's own storages
    for jrep, trep in zip(jrs.replicas, trs.replicas):
        _, _, tp, to = _carried(jt, tt)
        for k, v in tp.items():
            trep["params"][k].copy_(v)
        assert np.array_equal(np.asarray(jrep["params"]["fc1/weight"]),
                              trep["params"]["fc1/weight"].numpy())
    return jrs, trs


def _streams(base):
    return [synthetic_image_batches(32, seed=11, stream_seed=base + g)
            for g in range(2)]


def _losses(hist):
    return [h["loss"] for h in hist]


def test_replica_set_elastic_center_matches_jax():
    jrs, trs = _replica_sets("Elastic")
    jcenter, jhist = jrs.run(_streams(60), steps=12, seed=0)
    tcenter, thist = trs.run(_streams(60), steps=12, seed=0)
    _close(tcenter, jcenter, RTOL_TRAIN, ATOL_TRAIN)
    for g in range(2):
        _close(trs.replicas[g]["params"], jrs.replicas[g]["params"],
               RTOL_TRAIN, ATOL_TRAIN)
        np.testing.assert_allclose(_losses(thist[g]), _losses(jhist[g]),
                                   rtol=1e-5)
    # one center, per-replica storage: no tensor is shared
    ptrs = [{v.data_ptr() for v in rep["params"].values()}
            for rep in trs.replicas]
    ptrs.append({v.data_ptr() for v in tcenter.values()})
    assert sum(map(len, ptrs)) == len(set().union(*ptrs))
    assert all(c.center is tcenter for c in trs.controllers)


def test_replica_set_randomsync_trains_and_reproduces_from_its_seed():
    runs = []
    for _ in range(2):
        _, trs = _replica_sets("RandomSync", momentum=0.0)
        center, hist = trs.run(_streams(60), steps=30, seed=0)
        runs.append((center, hist, trs))
    (c1, h1, rs1), (c2, h2, _) = runs
    for g in range(2):
        first, last = np.mean(_losses(h1[g])[:5]), np.mean(
            _losses(h1[g])[-5:])
        assert last < first * 0.5, (g, first, last)
        assert _losses(h1[g]) == _losses(h2[g])
        snap = rs1.controllers[g].snapshot
        assert snap is not None and snap is not c1
    for k in c1:
        assert torch.equal(c1[k], c2[k]), k
    assert all(c.sample_ratio == 1.0 for c in rs1.controllers)


def test_replica_set_measures_syncconfig_after_warmup():
    _, trs = _replica_sets("RandomSync", momentum=0.0, bandwidth_mb_s=1e-9)
    trs.run(_streams(70), steps=6, seed=0)
    assert all(c.sample_ratio < 0.01 for c in trs.controllers), \
        [c.sample_ratio for c in trs.controllers]


@pytest.mark.parametrize("param_type,momentum", [("Elastic", None),
                                                ("RandomSync", 0.0)])
def test_replica_set_quarantine_matches_jax(param_type, momentum):
    """Replica 0's contributions at steps 6, 8 and 10 (the site's visits
    1, 3 and 5, counted from 0; replica 0 seeded the center at step 4)
    poisoned 3 rounds running: both packages quarantine it at step 10;
    replica 1 trains on."""
    spec = "sync.delta@1:nan,sync.delta@3:nan,sync.delta@5:nan"
    jrs, trs = _replica_sets(param_type, momentum=momentum)
    with jfaults.inject(jfaults.FaultSchedule.parse(spec, seed=0)):
        _, jhist = jrs.run(_streams(90), steps=14, seed=0)
    with tfaults.inject(tfaults.FaultSchedule.parse(spec, seed=0)):
        _, thist = trs.run(_streams(90), steps=14, seed=0)
    assert [r["quarantined"] for r in trs.replicas] == \
        [r["quarantined"] for r in jrs.replicas] == [True, False]
    assert [len(h) for h in thist] == [len(h) for h in jhist] == [10, 14]
    assert [c.poisoned_rounds for c in trs.controllers] == \
        [c.poisoned_rounds for c in jrs.controllers] == [3, 0]


# -- the CLI ---------------------------------------------------------------

def test_cli_trains_the_narrowed_mlp_past_its_warmup(tmp_path, capsys):
    conf = tmp_path / "mlp.conf"
    conf.write_text(_mlp_text(steps=12))
    argv = ["-model_conf", str(conf), "--synthetic", "--steps", "12"]
    assert tmain.main(argv, device="cpu") == 0
    out = capsys.readouterr()
    assert "async consistency tier active: Elastic sync_frequency=2 " \
           "warmup=4" in out.out + out.err
    assert jmain(argv) == 0


def test_cli_trains_async_worker_groups(tmp_path, capsys):
    conf = tmp_path / "mlp.conf"
    conf.write_text(_mlp_text(steps=12))
    cluster = tmp_path / "cluster.conf"
    cluster.write_text("nworkers: 2\nnprocs_per_group: 1\n"
                       "synchronous: false\n")
    argv = ["-model_conf", str(conf), "-cluster_conf", str(cluster),
            "--synthetic", "--steps", "12"]
    assert tmain.main(argv, device="cpu") == 0
    got = capsys.readouterr()
    got = got.out + got.err
    assert jmain(argv) == 0
    want = capsys.readouterr()
    want = want.out + want.err
    for text in (got, want):
        assert "async replica groups: 2 x Elastic" in text
        assert "training done (center of 2 replicas)" in text
        assert "center test: loss" in text
