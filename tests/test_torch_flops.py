"""The port's FLOP accounting (`singa_tpu_torch/utils/flops.py`) against
the JAX package's (`singa_tpu/utils/flops.py`): the analytic forward and
train counts are the same integers on every shipped config and on a
fused-head transformer; LeNet's formula; linearity in batch; the counted
FLOPs of an eager forward against the analytic count; the peak table
and MFU.  Shapes only, except the counted forward (LeNet at batch 8)."""

import os

import numpy as np
import pytest
import torch

from singa_tpu.config import load_model_config as jload
from singa_tpu.core.net import build_net as jbuild
from singa_tpu.data import discover_input_shapes as jdiscover
from singa_tpu.models.transformer import transformer_lm as jtransformer_lm
from singa_tpu.utils import flops as jflops

from singa_tpu_torch.config import load_model_config
from singa_tpu_torch.core.net import build_net
from singa_tpu_torch.data.discovery import discover_input_shapes
from singa_tpu_torch.models.transformer import transformer_lm
from singa_tpu_torch.utils import flops
from singa_tpu_torch.weights import numpy_params, params_from_numpy

from port_fixture import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.port
EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
CONFS = ["mnist/conv.conf", "mnist/mlp.conf", "mnist/rbm.conf",
         "cifar10/quick.conf", "cifar10/alexnet.conf",
         "imagenet/alexnet.conf", "transformer/lm.conf",
         "transformer/lm_tiny.conf"]
MNIST_SHAPES = {"data": {"pixel": (28, 28), "label": ()}}


def _nets(rel):
    path = os.path.join(EXAMPLES, rel)
    model, jmodel = load_model_config(path), jload(path)
    return (build_net(model, "kTrain",
                      discover_input_shapes(model, force_synthetic=True)),
            jbuild(jmodel, "kTrain",
                   jdiscover(jmodel, force_synthetic=True)))


@pytest.mark.parametrize("rel", CONFS)
def test_analytic_counts_equal_the_jax_packages(rel):
    net, jnet = _nets(rel)
    fwd = flops.net_forward_flops(net)
    assert fwd == jflops.net_forward_flops(jnet)
    assert flops.net_train_flops(net) == jflops.net_train_flops(jnet)
    for name in net.topo:
        assert flops.layer_forward_flops(net.layers[name]) == \
            jflops.layer_forward_flops(jnet.layers[name]), name
    if rel != "mnist/rbm.conf":     # kRBM is not a counted layer
        assert fwd > 0


def test_fused_head_transformer_counts_equal_the_jax_packages():
    kw = dict(vocab_size=512, num_layers=2, embed_dim=64, num_heads=4,
              head_dim=16, num_kv_heads=2, ffn_hidden=128, seq_len=32,
              batchsize=2, moe_every=2, num_experts=4)
    shapes = {"data": {"input": (32,), "target": (32,)}}
    net = build_net(transformer_lm(**kw), "kTrain", shapes)
    jnet = jbuild(jtransformer_lm(**kw), "kTrain", shapes)
    assert net.layers["loss"].cfg.type == "kLMHeadLoss"
    assert net.layers["loss"].flops_shape == jnet.layers["loss"].flops_shape
    assert flops.layer_forward_flops(net.layers["loss"]) == 2 * 2 * 32 * 64 * 512
    assert flops.net_forward_flops(net) == jflops.net_forward_flops(jnet)
    assert flops.net_train_flops(net) == jflops.net_train_flops(jnet)


def _lenet(bs):
    cfg = load_model_config(os.path.join(EXAMPLES, "mnist", "conv.conf"))
    return build_net(cfg, "kTrain", MNIST_SHAPES, batchsize=bs)


def test_analytic_lenet_flops_formula():
    net = _lenet(1)
    # conv1 2·20·24·24·5·5·1 + conv2 2·50·8·8·5·5·20 + ip1 + ip2, a sample
    conv1 = 2 * 20 * 24 * 24 * 25
    conv2 = 2 * 50 * 8 * 8 * 25 * 20
    shapes = {s.name: s.shape for s in net.param_specs.values()}
    ip1 = 2 * int(np.prod(shapes["ip1/weight"]))
    ip2 = 2 * int(np.prod(shapes["ip2/weight"]))
    assert flops.net_forward_flops(net) == conv1 + conv2 + ip1 + ip2
    assert flops.net_train_flops(net) == 3 * flops.net_forward_flops(net)


def test_analytic_scales_linearly_with_batch():
    assert flops.net_forward_flops(_lenet(8)) * 8 == \
        flops.net_forward_flops(_lenet(64))


def test_counted_flops_close_to_analytic():
    bs = 8
    net = _lenet(bs)
    params = params_from_numpy(net, numpy_params(net, seed=0), device="cpu")
    rng = np.random.default_rng(0)
    batch = {"data": {
        "pixel": rng.integers(0, 256, (bs, 28, 28)).astype(np.uint8),
        "label": rng.integers(0, 10, (bs,)).astype(np.int32)}}

    def forward(p, b):
        with torch.no_grad():
            return net.apply(p, b, train=False)[0]

    got = flops.counted_flops(forward, params, batch)
    analytic = flops.net_forward_flops(net)
    assert got is not None
    assert analytic <= got <= 1.5 * analytic
    assert flops.counted_flops(lambda: torch.ones(3) + 1) is None


def test_peak_lookup_and_mfu(monkeypatch):
    assert flops.peak_flops("cpu") is None
    assert flops.peak_flops(torch.device("cpu")) is None
    assert flops.mfu(1e12, 1.0, "cpu") is None
    # the card's name, as torch reports it, keys the table
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert flops.peak_flops(0) == 989e12
    assert flops.peak_flops("cuda:0") == 989e12
    # 989e12 FLOPs in 2 s on a 989e12 peak: half of it
    assert flops.mfu(989e12, 2.0, 0) == pytest.approx(0.5)
    assert flops.mfu(989e12, 0.0, 0) is None
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "Some Other Card")
    assert flops.peak_flops(0) is None
    if not torch.cuda.is_available():
        assert flops.peak_flops() is None
