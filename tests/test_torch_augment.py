"""kMnistImage's elastic distortion (singa_tpu_torch/ops/augment.py) and
kRGBImage's meanfile against the JAX package, on the CPU.

The port draws from a torch.Generator and JAX from a threefry key, so the
draws are not compared; the deterministic warp is.  Each test computes
the four fields from JAX's key exactly as `singa_tpu.ops.augment.
elastic_deform` splits and draws them and feeds them to the port's
`elastic_warp`.  Tolerances, each with its reason:
- the warp, on images in [0, 1): atol 1e-5 (cos, sin and the blur's sums
  round differently in the two libraries; a coordinate off by 1e-6 moves
  a bilinear sample by at most that times the pixel step);
- the Gaussian kernel: 1e-7 (the same f32 formula);
- the meanfile path: rtol 1e-6 (one f32 subtraction).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.config.schema import model_config_from_dict as jfrom_dict
from singa_tpu.core.net import build_net as jbuild_net
from singa_tpu.data.records import Record as JRecord
from singa_tpu.data.records import SingleLabelImageRecord as JImage
from singa_tpu.ops import augment as jaug

from singa_tpu_torch.config.schema import model_config_from_dict
from singa_tpu_torch.core.layers import LayerError
from singa_tpu_torch.core.net import build_net
from singa_tpu_torch.core.trainer import Trainer
from singa_tpu_torch.data.records import Record, SingleLabelImageRecord
from singa_tpu_torch.ops import augment

from port_fixture import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.port
MNIST = {"data": {"pixel": (28, 28), "label": ()}}


def _jax_draws(key, b, h, w, beta, gamma):
    """The four fields `elastic_deform` draws from `key`, as it draws
    them."""
    k_rot, k_sc, k_dx, k_dy = jax.random.split(key, 4)
    return tuple(np.array(a) for a in (
        jax.random.uniform(k_rot, (b,), minval=-beta, maxval=beta),
        jax.random.uniform(k_sc, (b, 2), minval=-gamma, maxval=gamma),
        jax.random.uniform(k_dx, (b, h, w), minval=-1.0, maxval=1.0),
        jax.random.uniform(k_dy, (b, h, w), minval=-1.0, maxval=1.0)))


@pytest.mark.parametrize("size,sigma", [(3, 1.0), (4, 2.0), (5, 6.0),
                                        (7, 0.0)])
def test_gaussian_kernel_matches_jax(size, sigma):
    got = augment.gaussian_kernel(size, sigma).numpy()
    want = np.asarray(jaug.gaussian_kernel(size, sigma))
    assert got.shape == (size, size)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


WARPS = {   # kernel, sigma, alpha, beta, gamma
    "affine-only": (0, 0.0, 0.0, 15.0, 20.0),
    "k3-elastic": (3, 1.0, 8.0, 0.0, 0.0),
    "k5-elastic": (5, 6.0, 34.0, 0.0, 0.0),
    "k5-all": (5, 2.0, 8.0, 15.0, 15.0),
    "k3-alpha-off": (3, 1.0, 0.0, 10.0, 0.0),
    "k4-even": (4, 2.0, 5.0, 5.0, 5.0),
    "identity": (0, 0.0, 0.0, 0.0, 0.0),
}


@pytest.mark.parametrize("case", sorted(WARPS))
def test_elastic_warp_matches_jax(case):
    kernel, sigma, alpha, beta, gamma = WARPS[case]
    x = np.random.default_rng(len(case)).random((4, 28, 28)) \
        .astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jaug.elastic_deform(
        jnp.asarray(x), key, kernel=kernel, sigma=sigma, alpha=alpha,
        beta=beta, gamma=gamma))
    rot, sc, dx, dy = (torch.from_numpy(a) for a in
                       _jax_draws(key, 4, 28, 28, beta, gamma))
    got = augment.elastic_warp(torch.from_numpy(x), rot, sc, dx, dy,
                               kernel=kernel, sigma=sigma,
                               alpha=alpha).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if case == "identity":
        np.testing.assert_array_equal(got, x)


def test_elastic_deform_draws_from_its_generator():
    """The draws: rotation in [-beta, beta], scales in [-gamma, gamma],
    fields in [-1, 1], in that order from the generator; the same seed
    deforms alike, another seed otherwise; no field is drawn when the
    elastic part is off."""
    x = torch.from_numpy(np.random.default_rng(0).random((3, 28, 28))
                         .astype(np.float32))
    kw = dict(kernel=5, sigma=2.0, alpha=8.0, beta=15.0, gamma=15.0)

    def gen(seed):
        return torch.Generator().manual_seed(seed)
    rot, sc, dx, dy = augment.elastic_draws(3, 28, 28, gen(1), x.device,
                                            kernel=5, alpha=8.0, beta=15.0,
                                            gamma=15.0)
    assert rot.abs().max() <= 15.0 and sc.abs().max() <= 15.0
    assert dx.abs().max() <= 1.0 and dy.shape == (3, 28, 28)
    a = augment.elastic_deform(x, gen(1), **kw)
    assert torch.equal(a, augment.elastic_warp(x, rot, sc, dx, dy,
                                               kernel=5, sigma=2.0,
                                               alpha=8.0))
    assert torch.equal(a, augment.elastic_deform(x, gen(1), **kw))
    assert not torch.equal(a, augment.elastic_deform(x, gen(2), **kw))
    _, _, ndx, ndy = augment.elastic_draws(3, 28, 28, gen(1), x.device,
                                           kernel=5, alpha=0.0, beta=15.0)
    assert ndx is None and ndy is None


def _mnist_cfg(from_dict, **mnist_kw):
    layers = [
        {"name": "data", "type": "kShardData",
         "data_param": {"batchsize": 4}},
        {"name": "mnist", "type": "kMnistImage", "srclayers": "data",
         "mnist_param": {"norm_a": 255.0, **mnist_kw}},
        {"name": "label", "type": "kLabel", "srclayers": "data"},
        {"name": "ip", "type": "kInnerProduct", "srclayers": "mnist",
         "inner_product_param": {"num_output": 10},
         "param": [{"name": "weight"}, {"name": "bias"}]},
        {"name": "loss", "type": "kSoftmaxLoss",
         "srclayers": ["ip", "label"]},
    ]
    return from_dict({
        "name": "mnisttest", "train_steps": 12,
        "updater": {"type": "kSGD", "base_learning_rate": 0.1,
                    "learning_rate_change_method": "kFixed"},
        "neuralnet": {"layer": layers}})


def _pixels(seed=0, b=4):
    rng = np.random.default_rng(seed)
    return {"data": {"pixel": rng.integers(0, 256, (b, 28, 28))
                     .astype(np.float32),
                     "label": rng.integers(0, 10, (b,)).astype(np.int32)}}


def test_elastic_freq_gates_distortion_by_step():
    """elastic_freq=4 distorts at steps 0, 4, 8 and leaves the others
    at the plain parse, as the JAX layer's lax.cond does
    (tests/test_data_gaps.py:138); the gate is the step's variant, which
    keys the captured graphs."""
    kw = dict(alpha=8.0, sigma=6.0, kernel=5, elastic_freq=4)
    batch = _pixels()
    plain = batch["data"]["pixel"] / 255.0
    jnet = jbuild_net(_mnist_cfg(jfrom_dict, **kw), "kTrain", MNIST)
    net = build_net(_mnist_cfg(model_config_from_dict, **kw), "kTrain",
                    MNIST)
    jparams = jnet.init_params(jax.random.PRNGKey(0))
    params = {k: torch.from_numpy(np.array(v)) for k, v in jparams.items()}
    key = jax.random.PRNGKey(3)
    for step in range(10):
        on = step % 4 == 0
        assert net.step_variant(step) == (("mnist", on),)
        _, _, jout = jnet.apply(jparams, jax.tree_util.tree_map(
            jnp.asarray, batch), rng=key, train=True, step=step)
        _, _, out = net.apply(params, batch, rng=0, train=True, step=step)
        for got in (np.asarray(jout["mnist"]), out["mnist"].numpy()):
            moved = np.abs(got - plain).max()
            if on:
                assert moved > 1e-3, step
            else:
                np.testing.assert_allclose(got, plain, rtol=1e-5,
                                           atol=1e-6)


def test_distorted_steps_reproduce_through_the_trainer():
    """The trainer seeds the parser's own generator per step: the same
    step distorts alike on two trainers, eager steps of a distorting
    net train (elastic_freq 0: every step), and a run that resumes from
    a copy of the state at step 2 ends where an uninterrupted one does."""
    cfg = _mnist_cfg(model_config_from_dict, alpha=8.0, sigma=4.0, kernel=5,
                     beta=10.0, gamma=10.0)
    runs = []
    for split in (None, 2):
        tr = Trainer(cfg, MNIST, device="cpu", log_fn=lambda m: None,
                     seed=5)
        assert list(tr._gens) == [1]     # the parser, by topological index
        p, o = tr.init(0)
        for step in range(4):
            if step == split:
                p = {k: v.clone() for k, v in p.items()}
                o = {s: {k: v.clone() for k, v in d.items()}
                     for s, d in o.items()}
                tr = Trainer(cfg, MNIST, device="cpu",
                             log_fn=lambda m: None, seed=5)
            p, o, m = tr.train_step(p, o, _pixels(step), step)
            assert math.isfinite(float(m["loss"]))
        runs.append(p)
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k]), k


def _rgb_cfg(from_dict, meanfile=""):
    layers = [
        {"name": "data", "type": "kShardData",
         "data_param": {"batchsize": 4}},
        {"name": "rgb", "type": "kRGBImage", "srclayers": "data",
         "rgbimage_param": {"scale": 1.0, "meanfile": meanfile}},
        {"name": "label", "type": "kLabel", "srclayers": "data"},
        {"name": "ip", "type": "kInnerProduct", "srclayers": "rgb",
         "inner_product_param": {"num_output": 10},
         "param": [{"name": "weight"}, {"name": "bias"}]},
        {"name": "loss", "type": "kSoftmaxLoss",
         "srclayers": ["ip", "label"]},
    ]
    return from_dict({
        "name": "rgbtest", "train_steps": 1,
        "updater": {"type": "kSGD", "base_learning_rate": 0.1,
                    "learning_rate_change_method": "kFixed"},
        "neuralnet": {"layer": layers}})


RGB = {"data": {"pixel": (3, 8, 8), "label": ()}}


def _write_mean(path, mean, record=Record, image=SingleLabelImageRecord):
    rec = record(image=image(shape=list(mean.shape),
                             data=[float(x) for x in mean.ravel()]))
    with open(path, "wb") as f:
        f.write(rec.encode())


def test_meanfile_is_loaded_and_subtracted(tmp_path):
    """layer.cc:571-643, as tests/test_data_gaps.py:46-71: the mean
    record is subtracted per pixel before crop and scale; the port reads
    a record the JAX package wrote, matches the JAX net's output, and a
    batch's own `mean` wins over the file."""
    mean = np.random.default_rng(1).random((3, 8, 8)).astype(np.float32) \
        * 100
    path = str(tmp_path / "mean.rec")
    _write_mean(path, mean, JRecord, JImage)
    rng = np.random.default_rng(0)
    pix = rng.integers(0, 256, (4, 3, 8, 8)).astype(np.float32)
    batch = {"data": {"pixel": pix,
                      "label": rng.integers(0, 10, (4,)).astype(np.int32)}}
    jnet = jbuild_net(_rgb_cfg(jfrom_dict, path), "kTrain", RGB)
    net = build_net(_rgb_cfg(model_config_from_dict, path), "kTrain", RGB)
    plain = build_net(_rgb_cfg(model_config_from_dict), "kTrain", RGB)
    jparams = jnet.init_params(jax.random.PRNGKey(0))
    params = {k: torch.from_numpy(np.array(v)) for k, v in jparams.items()}
    _, _, jout = jnet.apply(jparams, jax.tree_util.tree_map(jnp.asarray,
                                                            batch),
                            train=False)
    _, _, out = net.apply(params, batch, train=False)
    _, _, out_plain = plain.apply(params, batch, train=False)
    np.testing.assert_allclose(out["rgb"].numpy(), np.asarray(jout["rgb"]),
                               rtol=1e-6)
    np.testing.assert_allclose(
        out["rgb"].numpy(),
        out_plain["rgb"].numpy() - mean.transpose(1, 2, 0), rtol=1e-6,
        atol=1e-4)
    # the mean is on the device once: the same tensor at every call
    layer = net.layers["rgb"]
    first = layer._file_mean(torch.device("cpu"))
    assert layer._file_mean(torch.device("cpu")) is first
    own = {"data": {**batch["data"], "mean": np.full((3, 8, 8), 3.0,
                                                     np.float32)}}
    _, _, out_own = net.apply(params, own, train=False)
    np.testing.assert_allclose(out_own["rgb"].numpy(),
                               out_plain["rgb"].numpy() - 3.0, rtol=1e-6)


def test_missing_or_malformed_meanfile_fails_loud(tmp_path):
    missing = str(tmp_path / "nope")
    with pytest.raises(LayerError, match="meanfile.*nope.*does not exist"):
        build_net(_rgb_cfg(model_config_from_dict, missing), "kTrain", RGB)
    bad = tmp_path / "bad.rec"
    bad.write_bytes(b"\xff\xff\xff\xff not a record")
    with pytest.raises(LayerError, match="bad.rec.*not a mean record"):
        build_net(_rgb_cfg(model_config_from_dict, str(bad)), "kTrain", RGB)
    wrong = str(tmp_path / "wrong.rec")
    _write_mean(wrong, np.zeros((2, 5), np.float32))
    rec = Record.decode(open(wrong, "rb").read())
    rec.image.shape = [3, 8, 8]          # 10 values for 192 pixels
    with open(wrong, "wb") as f:
        f.write(rec.encode())
    with pytest.raises(LayerError, match="wrong.rec.*not a mean record"):
        build_net(_rgb_cfg(model_config_from_dict, wrong), "kTrain", RGB)
