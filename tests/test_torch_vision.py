"""The port's vision zoo (singa_tpu_torch/core/layers.py, ops/conv.py,
ops/pool.py, ops/lrn.py, ops/linear.py, ops/dropout.py,
models/vision.py) against the JAX package, in f32 on the CPU.

The same numpy inputs go to both packages; the JAX params are carried
into the port by `params_from_numpy`.  Tolerances, each with its reason:
- loss, precision and every gradient at train=False: 1e-4 of the largest
  magnitude — the same f32 math, convolutions and window sums summed in
  another order by another library;
- three kSGD steps: params within 1e-5 (plus 1e-5 relative) — the same
  f32 update on gradients that agree to ~1e-6;
- MAX pooling's gradients on ReLU-tied inputs, the production backward
  and the tie-exact oracle: equal to the bit — each routes the same
  cotangent entries to the same positions.
The random layers (dropout, the RGB crop and mirror) cannot draw JAX's
threefry bits, so they are checked by their statistics and invariants.
"""

import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.config.schema import load_model_config as jload
from singa_tpu.config.schema import model_config_from_text as jfrom_text
from singa_tpu.core.net import build_net as jbuild_net
from singa_tpu.core.trainer import Trainer as JTrainer
from singa_tpu.models import vision as jvision
from singa_tpu.ops import pool as jpool

from singa_tpu_torch.config.schema import ParamConfig
from singa_tpu_torch.config.schema import load_model_config as tload
from singa_tpu_torch.config.schema import model_config_from_text as tfrom_text
from singa_tpu_torch.core.layers import LayerError
from singa_tpu_torch.core.net import build_net as tbuild_net
from singa_tpu_torch.core.trainer import Trainer
from singa_tpu_torch.data.synthetic import synthetic_image_batches
from singa_tpu_torch.models import vision as tvision
from singa_tpu_torch.ops import dropout as tdropout
from singa_tpu_torch.ops import pool as tpool
from singa_tpu_torch.weights import numpy_params, params_from_numpy

pytestmark = pytest.mark.port
REPO = __file__.rsplit("/tests/", 1)[0]
B = 4
RGB = {"data": {"pixel": (3, 32, 32), "label": ()}}
MNIST = {"data": {"pixel": (28, 28), "label": ()}}


def _narrow(cfg, widths, mirror=None, dropout=None, **updater):
    """Set num_filters / num_output of the named layers; optionally the
    RGB mirror, the dropout ratio and updater fields."""
    for layer in cfg.neuralnet.layer:
        if layer.name in widths:
            p = layer.convolution_param or layer.inner_product_param
            if layer.convolution_param is not None:
                p.num_filters = widths[layer.name]
            else:
                p.num_output = widths[layer.name]
        if mirror is not None and layer.rgbimage_param is not None:
            layer.rgbimage_param.mirror = mirror
        if dropout is not None and layer.dropout_param is not None:
            layer.dropout_param.dropout_ratio = dropout
    for k, v in updater.items():
        setattr(cfg.updater, k, v)
    return cfg


ALEX_WIDTHS = {"conv1": 8, "conv2": 16, "conv3": 16, "conv4": 16,
               "conv5": 16, "fc6": 32, "fc7": 32}
QUICK_WIDTHS = {"conv1": 8, "conv2": 8, "conv3": 16}
SLICE_NET = """
neuralnet {
  layer { name: "data" type: "kShardData" data_param { batchsize: 4 } }
  layer { name: "mnist" type: "kMnistImage" srclayers: "data"
          mnist_param { norm_a: 255.0 norm_b: 0.5 } }
  layer { name: "label" type: "kLabel" srclayers: "data" }
  layer { name: "slice" type: "kSlice" srclayers: "mnist"
          slice_param { slice_dimension: 1 slice_num: 2 } }
  layer { name: "fca" type: "kInnerProduct" srclayers: "slice"
          inner_product_param { num_output: 6 }
          param { name: "weight" init_method: "kGaussain" std: 0.1 }
          param { name: "bias" init_method: "kConstant" value: 0.1 } }
  layer { name: "fcb" type: "kInnerProduct" srclayers: "slice"
          inner_product_param { num_output: 5 }
          param { name: "weight" init_method: "kGaussain" std: 0.1 }
          param { name: "bias" init_method: "kConstant" value: 0.1 } }
  layer { name: "ta" type: "kTanh" srclayers: "fca" }
  layer { name: "sb" type: "kSigmoid" srclayers: "fcb" }
  layer { name: "cat" type: "kConcate" srclayers: "ta" srclayers: "sb"
          concate_param { concate_dimension: 1 } }
  layer { name: "split" type: "kSplit" srclayers: "cat" }
  layer { name: "bridge" type: "kBridgeSrc" srclayers: "split" }
  layer { name: "out" type: "kInnerProduct" srclayers: "bridge"
          inner_product_param { num_output: 10 }
          param { name: "weight" init_method: "kGaussain" std: 0.1 }
          param { name: "bias" init_method: "kConstant" value: 0.0 } }
  layer { name: "loss" type: "kSoftmaxLoss" srclayers: "out"
          srclayers: "label" }
}
"""


IMAGENET_WIDTHS = {"conv1": 8, "conv2": 8, "conv3": 8, "conv4": 8,
                   "conv5": 8, "fc6": 16, "fc7": 16}
IMAGENET = {"data": {"pixel": (3, 256, 256), "label": ()}}
# batch per net where it is not B: ImageNet-sized images at batch 2
BATCH = {"imagenet": 2}


def _configs(name):
    """(JAX config, port config, input shapes) of one test net."""
    if name in ("lenet", "mlp", "rbm"):
        conf = {"lenet": "conv", "mlp": "mlp", "rbm": "rbm"}[name]
        path = f"{REPO}/examples/mnist/{conf}.conf"
        return jload(path), tload(path), MNIST
    if name == "imagenet":
        path = f"{REPO}/examples/imagenet/alexnet.conf"
        return (_narrow(jload(path), IMAGENET_WIDTHS),
                _narrow(tload(path), IMAGENET_WIDTHS), IMAGENET)
    if name == "alexnet":
        return (_narrow(jvision.alexnet_cifar10_full(B), ALEX_WIDTHS),
                _narrow(tvision.alexnet_cifar10_full(B), ALEX_WIDTHS), RGB)
    if name == "quick":
        return (_narrow(jvision.alexnet_cifar10(B), QUICK_WIDTHS),
                _narrow(tvision.alexnet_cifar10(B), QUICK_WIDTHS), RGB)
    return jfrom_text(SLICE_NET), tfrom_text(SLICE_NET), MNIST


def _batch(shapes, seed, b=B):
    sample = shapes["data"]["pixel"]
    return next(synthetic_image_batches(b, sample, seed=seed))


def _jax_params(jnet, seed=0):
    """The JAX net's params as numpy, each weight rescaled to He's std
    sqrt(2 / fan-in): at the configs' own stds (1e-4 to 1e-2 over five
    layers) the first layers' gradients fall to ~1e-9, where f32
    cancellation, not the port, decides their low bits."""
    out = {}
    for k, v in jnet.init_params(jax.random.PRNGKey(seed)).items():
        v = np.asarray(v)
        if k.endswith("/weight"):
            conv = jnet.layers[k.split("/")[0]].type_name == "kConvolution"
            fan = v.shape[1] if conv else v.shape[0]
            v = v * (math.sqrt(2.0 / fan) / v.std())
        out[k] = v.astype(np.float32)
    return out


@pytest.mark.parametrize("name", ["lenet", "alexnet", "quick", "slice",
                                  "mlp", "imagenet"])
def test_net_loss_and_every_gradient_match_jax(name):
    jcfg, tcfg, shapes = _configs(name)
    jnet = jbuild_net(jcfg, "kTrain", shapes)
    tnet = tbuild_net(tcfg, "kTrain", shapes)
    assert sorted(jnet.param_specs) == sorted(tnet.param_specs)
    if name == "alexnet":   # both LRNs take the fused relu+LRN kernels
        assert tnet.layers["norm1"].fuse_from == "conv1"
        assert tnet.layers["norm2"].fuse_from == "conv2"
    if name == "quick":     # norm1 fused (relu of a pool), norm2 not
        assert tnet.layers["norm1"].fuse_from == "pool1"
        assert tnet.layers["norm2"].fuse_from == ""
    arrays = _jax_params(jnet)
    batch = _batch(shapes, seed=5, b=BATCH.get(name, B))

    def loss_fn(p):
        loss, metrics, _ = jnet.apply(
            p, jax.tree_util.tree_map(jnp.asarray, batch), train=False)
        return loss, metrics
    (jl, jm), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        {k: jnp.asarray(v) for k, v in arrays.items()})

    params = params_from_numpy(tnet, arrays, device="cpu")
    for p in params.values():
        p.requires_grad_(True)
    tl, tm, _ = tnet.apply(params, batch, train=False)
    names = sorted(params)
    tg = torch.autograd.grad(tl, [params[k] for k in names])
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
    assert float(tm["precision"]) == pytest.approx(float(jm["precision"]))
    for k, g in zip(names, tg):
        want = np.asarray(jg[k])
        top = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-4 * top,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["mlp", "imagenet", "rbm"])
def test_net_forward_matches_jax(name):
    """Every layer's output at train=False, the JAX net's against the
    port's on the same weights and batch: within 1e-5 of each output's
    largest magnitude (f32 sums in another order).  For rbm.conf this is
    its whole forward: the stacked kRBM hidden probabilities."""
    jcfg, tcfg, shapes = _configs(name)
    jnet = jbuild_net(jcfg, "kTrain", shapes)
    tnet = tbuild_net(tcfg, "kTrain", shapes)
    assert jnet.topo == tnet.topo
    arrays = _jax_params(jnet)
    batch = _batch(shapes, seed=6, b=BATCH.get(name, B))
    _, _, jout = jax.jit(lambda p, b: jnet.apply(p, b, train=False))(
        {k: jnp.asarray(v) for k, v in arrays.items()},
        jax.tree_util.tree_map(jnp.asarray, batch))
    params = params_from_numpy(tnet, arrays, device="cpu")
    with torch.no_grad():
        _, _, tout = tnet.apply(params, batch, train=False)
    for layer in tnet.topo:
        want, got = jout[layer], tout[layer]
        if isinstance(want, dict):      # data layers and the loss
            continue
        want = np.asarray(want, np.float32)
        top = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=1e-5 * top, err_msg=layer)


def test_alexnet_sgd_trajectory_matches_jax():
    """Three kSGD steps (momentum 0.9, weight decay 5e-4, bias lr
    multiplier 2.0, kStep with a change every 2 steps) of the narrowed
    AlexNet, dropout and mirror off so both sides are deterministic."""
    kw = dict(mirror=False, dropout=0.0, learning_rate_change_frequency=2,
              base_learning_rate=0.001)
    jcfg = _narrow(jvision.alexnet_cifar10_full(B), ALEX_WIDTHS, **kw)
    tcfg = _narrow(tvision.alexnet_cifar10_full(B), ALEX_WIDTHS, **kw)
    jtr = JTrainer(jcfg, RGB, log_fn=lambda s: None)
    ttr = Trainer(tcfg, RGB, log_fn=lambda s: None, device="cpu")
    arrays = _jax_params(jtr.train_net, seed=1)
    jp = {k: jnp.asarray(v) for k, v in arrays.items()}
    jo = jtr.updater.init(jp)
    tp = params_from_numpy(ttr.train_net, arrays, device="cpu")
    to = ttr.updater.init(tp)
    data = synthetic_image_batches(B, (3, 32, 32), seed=2)
    for step in range(3):
        batch = next(data)
        jp, jo, jm = jtr.train_step(
            jp, jo, jax.tree_util.tree_map(jnp.asarray, batch), step,
            jax.random.PRNGKey(0))
        tp, to, tm = ttr.train_step(tp, to, batch, step)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    for k in arrays:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_dropout_draws_per_step_and_reproduces():
    """The trainer's generators: the same step draws the same masks, the
    next step other ones (the per-step fold of seed, step and layer)."""
    cfg = _narrow(tvision.alexnet_cifar10_full(B), ALEX_WIDTHS, mirror=False)
    tr = Trainer(cfg, RGB, log_fn=lambda s: None, device="cpu")
    params = params_from_numpy(tr.train_net, numpy_params(tr.train_net, 3),
                               device="cpu")
    batch = _batch(RGB, seed=4)
    m0, g0 = tr.gradients(params, batch, step=0)
    m0b, g0b = tr.gradients(params, batch, step=0)
    m1, g1 = tr.gradients(params, batch, step=1)
    assert all(torch.equal(g0[k], g0b[k]) for k in g0)
    assert not torch.equal(g0["fc7/weight"], g1["fc7/weight"])


@pytest.mark.parametrize("mode", ["MAX", "AVE"])
@pytest.mark.parametrize("kernel,stride", [(3, 2), (2, 2), (1, 3), (2, 3)])
def test_pool_geometry_and_values_match_jax(mode, kernel, stride):
    """Output size is pooled_size = ceil((h-k)/s)+1 for k >= s and k < s
    (a last window may start in the padding: -inf for MAX, 0 for AVE)."""
    x = np.random.default_rng(kernel * 10 + stride).standard_normal(
        (2, 7, 8, 3)).astype(np.float32)
    tfn, jfn = ((tpool.max_pool2d, jpool.max_pool2d) if mode == "MAX"
                else (tpool.avg_pool2d, jpool.avg_pool2d))
    got = tfn(torch.from_numpy(x), kernel, stride).numpy()
    want = np.asarray(jfn(jnp.asarray(x), kernel, stride, layout="NHWC"))
    assert got.shape == (2, tpool.pooled_size(7, kernel, stride),
                         tpool.pooled_size(8, kernel, stride), 3)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _relu_tied(shape, seed):
    """ReLU of a normal draw less 1: 84% of the entries are 0, so windows
    tie (an all-zero window ties everywhere)."""
    x = np.random.default_rng(seed).standard_normal(shape) - 1.0
    return np.maximum(x, 0.0).astype(np.float32)


def _port_vjp(fn, x, cot):
    t = torch.from_numpy(x).requires_grad_(True)
    y = fn(t)
    (dx,) = torch.autograd.grad(y, t, torch.from_numpy(cot))
    return y.detach().numpy(), dx.numpy()


@pytest.mark.parametrize("kernel,stride", [(3, 2), (2, 2), (3, 3)])
@pytest.mark.parametrize("size", [12, 13])
def test_max_pool_backward_routes_ties_as_jax_grad(kernel, stride, size):
    """The production MAX backward (autograd of `max_pool2d`) against
    `jax.grad` of the JAX `max_pool2d(..., layout="NHWC")` (its
    select-and-scatter) on ReLU-tied inputs: each window's gradient goes
    to the same single position, the first maximum, bit for bit."""
    x = _relu_tied((2, size, size, 4), seed=kernel * 100 + stride * 10 + size)
    oh = tpool.pooled_size(size, kernel, stride)
    cot = np.random.default_rng(size).standard_normal(
        (2, oh, oh, 4)).astype(np.float32)
    y, dx = _port_vjp(lambda t: tpool.max_pool2d(t, kernel, stride), x, cot)
    want = np.asarray(jax.grad(lambda t: jnp.sum(
        jpool.max_pool2d(t, kernel, stride, layout="NHWC") * cot))(
            jnp.asarray(x)))
    assert (y == 0).any()                     # some window is all ties
    np.testing.assert_array_equal(dx, want)


def test_tie_exact_max_pool_oracle_matches_jax():
    """`max_pool_tie_exact` against the JAX `_max_pool_nhwc` on the inputs
    of `tests/test_ops.py:374-395`: a constant input, where every position
    of a 2x2/2 window ties and receives the window's whole gradient, and
    untied data, where it is the production backward."""
    from singa_tpu.ops.pool import _max_pool_nhwc
    x = np.ones((1, 4, 4, 1), np.float32)
    _, dx = _port_vjp(lambda t: tpool.max_pool_tie_exact(t, 2, 2), x,
                      np.ones((1, 2, 2, 1), np.float32))
    _, jvjp = jax.vjp(lambda t: _max_pool_nhwc(t, 2, 2), jnp.asarray(x))
    np.testing.assert_array_equal(dx, np.ones((1, 4, 4, 1)))
    np.testing.assert_array_equal(
        dx, np.asarray(jvjp(jnp.ones((1, 2, 2, 1), jnp.float32))[0]))
    rng = np.random.default_rng(7)
    xr = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    cot = rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
    _, dx = _port_vjp(lambda t: tpool.max_pool_tie_exact(t, 3, 2), xr, cot)
    _, jvjp = jax.vjp(lambda t: _max_pool_nhwc(t, 3, 2), jnp.asarray(xr))
    np.testing.assert_allclose(dx, np.asarray(jvjp(jnp.asarray(cot))[0]),
                               atol=1e-6)
    _, prod = _port_vjp(lambda t: tpool.max_pool2d(t, 3, 2), xr, cot)
    np.testing.assert_allclose(dx, prod, atol=1e-6)


@pytest.mark.parametrize("kernel,stride", [(3, 2), (2, 2), (3, 3)])
@pytest.mark.parametrize("size", [12, 13])
def test_tie_exact_oracle_routes_every_tie_as_jax(kernel, stride, size):
    """On ReLU-tied inputs every tied maximum takes the window's gradient,
    in the port as in the JAX oracle, bit for bit (the same taps added in
    the same order)."""
    from singa_tpu.ops.pool import _max_pool_nhwc
    x = _relu_tied((2, size, size, 4), seed=kernel * 100 + stride * 10 + size)
    oh = tpool.pooled_size(size, kernel, stride)
    cot = np.random.default_rng(size).standard_normal(
        (2, oh, oh, 4)).astype(np.float32)
    y, dx = _port_vjp(lambda t: tpool.max_pool_tie_exact(t, kernel, stride),
                      x, cot)
    jy, jvjp = jax.vjp(lambda t: _max_pool_nhwc(t, kernel, stride),
                       jnp.asarray(x))
    np.testing.assert_array_equal(y, np.asarray(jy))
    np.testing.assert_array_equal(dx, np.asarray(jvjp(jnp.asarray(cot))[0]))


def _rgb_net(cropsize=0, mirror=True):
    text = f"""
    neuralnet {{
      layer {{ name: "data" type: "kShardData" data_param {{ batchsize: 64 }} }}
      layer {{ name: "rgb" type: "kRGBImage" srclayers: "data"
              rgbimage_param {{ scale: 1.0 cropsize: {cropsize}
                               mirror: {str(mirror).lower()} }} }}
    }}"""
    return tbuild_net(tfrom_text(text), "kTrain",
                      {"data": {"pixel": (3, 6, 6)}})


def test_rgb_image_mirrors_each_image_in_training():
    net = _rgb_net()
    pix = np.random.default_rng(0).integers(0, 256, (64, 3, 6, 6)) \
        .astype(np.uint8)
    nhwc = torch.from_numpy(pix.transpose(0, 2, 3, 1).astype(np.float32))
    params = {"unused": torch.zeros(1)}
    _, _, out = net.apply(params, {"data": {"pixel": pix}}, train=True,
                          rng=0, step=0)
    x = out["rgb"]
    same = [(x[i] == nhwc[i]).all().item() for i in range(64)]
    flipped = [(x[i] == nhwc[i].flip(1)).all().item() for i in range(64)]
    assert all(s or f for s, f in zip(same, flipped))
    assert 8 <= sum(flipped) <= 56          # a fair coin per image
    _, _, out = net.apply(params, {"data": {"pixel": pix}}, train=False)
    assert torch.equal(out["rgb"], nhwc)


def test_rgb_image_crops_per_image_and_centers_in_eval():
    net = _rgb_net(cropsize=4, mirror=False)
    pix = np.random.default_rng(1).integers(0, 256, (64, 3, 6, 6)) \
        .astype(np.uint8)
    nhwc = torch.from_numpy(pix.transpose(0, 2, 3, 1).astype(np.float32))
    params = {"unused": torch.zeros(1)}
    _, _, out = net.apply(params, {"data": {"pixel": pix}}, train=True,
                          rng=0, step=0)
    offsets = set()
    for i in range(64):
        hits = [(i0, j0) for i0 in range(2) for j0 in range(2)
                if torch.equal(out["rgb"][i], nhwc[i, i0:i0 + 4, j0:j0 + 4])]
        assert hits, i
        offsets.update(hits)
    assert len(offsets) > 1
    _, _, out = net.apply(params, {"data": {"pixel": pix}}, train=False)
    assert torch.equal(out["rgb"], nhwc[:, 1:5, 1:5])


def test_dropout_keeps_pkeep_scaled_and_is_identity_in_eval():
    x = torch.ones((200, 100))
    gen = torch.Generator().manual_seed(0)
    y = tdropout.dropout(x, 0.3, gen)
    kept = (y != 0).float().mean().item()
    sigma = math.sqrt(0.7 * 0.3 / x.numel())
    assert abs(kept - 0.7) < 5 * sigma
    assert torch.all(y[y != 0] == torch.tensor(1.0) / torch.tensor(0.7))
    assert tdropout.dropout(x, 0.3, gen, train=False) is x
    assert tdropout.dropout(x, 0.0, gen) is x


def test_mnist_resize_matches_jax_and_distortion_raises():
    """Resize matches JAX.  The distortion no longer raises (the name is
    older than the port of ops/augment.py): in training it deforms the
    resized images, the same for the same seed and step, and eval takes
    the plain path (tests/test_torch_augment.py holds it against JAX)."""
    text = """
    neuralnet {
      layer { name: "data" type: "kShardData" data_param { batchsize: 2 } }
      layer { name: "mnist" type: "kMnistImage" srclayers: "data"
              mnist_param { norm_a: 255.0 resize: 20 %s } }
    }"""
    pix = np.random.default_rng(2).integers(0, 256, (2, 28, 28)) \
        .astype(np.uint8)
    shapes = {"data": {"pixel": (28, 28)}}
    jnet = jbuild_net(jfrom_text(text % ""), "kTrain", shapes)
    tnet = tbuild_net(tfrom_text(text % ""), "kTrain", shapes)
    _, _, jout = jnet.apply({}, {"data": {"pixel": jnp.asarray(pix)}},
                            train=False)
    _, _, tout = tnet.apply({"unused": torch.zeros(1)},
                            {"data": {"pixel": pix}}, train=False)
    np.testing.assert_allclose(tout["mnist"].numpy(),
                               np.asarray(jout["mnist"]), atol=1e-5)
    tnet = tbuild_net(tfrom_text(text % "kernel: 5 sigma: 2.0 alpha: 4.0"),
                      "kTrain", shapes)
    runs = [tnet.apply({"unused": torch.zeros(1)}, {"data": {"pixel": pix}},
                       train=train, rng=0, step=0)[2]["mnist"]
            for train in (True, True, False)]
    assert runs[0].shape == (2, 20, 20) and torch.equal(runs[0], runs[1])
    assert (runs[0] - tout["mnist"]).abs().max() > 1e-3
    assert torch.equal(runs[2], tout["mnist"])


def test_rgb_meanfile_raises():
    """A configured meanfile that does not exist fails the build, naming
    the file (tests/test_torch_augment.py holds the loaded mean)."""
    text = """
    neuralnet {
      layer { name: "data" type: "kShardData" data_param { batchsize: 2 } }
      layer { name: "rgb" type: "kRGBImage" srclayers: "data"
              rgbimage_param { meanfile: "no-such-mean.bin" } }
    }"""
    with pytest.raises(LayerError,
                       match="'no-such-mean.bin' does not exist"):
        tbuild_net(tfrom_text(text), "kTrain",
                   {"data": {"pixel": (3, 8, 8)}})


INIT = {
    "kConstant": (dict(value=0.25), lambda s, f: (0.25, 0.0)),
    "kUniform": (dict(low=-0.5, high=1.5, value=2.0),
                 lambda s, f: (1.0, 2.0 * 2 / math.sqrt(12))),
    "kUniformSqrtFanIn": (dict(),
                          lambda s, f: (0.0, (2 / math.sqrt(12))
                                        / math.sqrt(f / 3.0))),
    "kUniformSqrtFanInOut": (dict(value=3.0),
                             lambda s, f: (0.0, 3.0 * (2 / math.sqrt(12))
                                           / math.sqrt(s[0] + s[1]))),
    "kGaussain": (dict(mean=0.5, std=0.1),
                  lambda s, f: (0.5, 0.1)),
    "kGaussainSqrtFanIn": (dict(mean=0.0, std=2.0),
                           lambda s, f: (0.0, 2.0 / math.sqrt(s[0]))),
    "kXavier": (dict(), lambda s, f: (0.0, math.sqrt(6.0 / (s[0] + s[1]))
                                      / math.sqrt(3))),
    "kMSRA": (dict(), lambda s, f: (0.0, math.sqrt(2.0 / f))),
}


@pytest.mark.parametrize("method", sorted(INIT))
def test_numpy_params_draws_every_init_method(method):
    """Mean and spread of each method's draw against its formula
    (core/init.py): 200x300 draws, so 5 standard errors is < 2%."""
    kw, moments = INIT[method]
    shape, fan_in = (200, 300), 75
    net = SimpleNamespace(param_specs={"w": SimpleNamespace(
        shape=shape, fan_in=fan_in,
        cfg=ParamConfig(init_method=method, **kw))})
    x = numpy_params(net, seed=0)["w"]
    assert x.dtype == np.float32 and x.shape == shape
    mean, std = moments(shape, fan_in)
    n = x.size
    assert abs(x.mean() - mean) <= 5 * std / math.sqrt(n) + 1e-7
    assert abs(x.std() - std) <= 0.02 * std + 1e-7


def test_numpy_params_refuses_pretrained():
    net = SimpleNamespace(param_specs={"w": SimpleNamespace(
        shape=(2, 2), fan_in=2, cfg=ParamConfig(init_method="kPretrained"))})
    with pytest.raises(ValueError, match="loaded"):
        numpy_params(net)
