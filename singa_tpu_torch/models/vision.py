"""Vision model zoo as NetProto-style configs built programmatically.

The port's own copy of `singa_tpu/models/vision.py:103-285`, builder for
builder, so a JAX net and a port net built from one call hold the same
layers and param keys.  The reference ships MNIST MLP + LeNet configs
(examples/mnist/{mlp,conv}.conf); its BASELINE configs also name AlexNet
on CIFAR-10 and ImageNet.  These builders emit the LayerConfig graphs the
text configs would, so everything downstream (net builder, trainer) is
the same whether a model comes from a .conf file or from here.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..config.schema import ModelConfig, model_config_from_dict


def _param(name, **kw):
    return {"name": name, **kw}


_UNIFORM = dict(init_method="kUniform", low=-0.05, high=0.05)
_FANIN = dict(init_method="kUniformSqrtFanIn")


def _conv(name, src, nf, kernel, stride=1, pad=0, std=None, bias_value=0.0,
          lr2=2.0):
    winit = (dict(init_method="kGaussain", std=std) if std is not None
             else _FANIN)
    return {
        "name": name, "type": "kConvolution", "srclayers": src,
        "convolution_param": {"num_filters": nf, "kernel": kernel,
                              "stride": stride, "pad": pad},
        "param": [
            _param("weight", **winit),
            _param("bias", init_method="kConstant", value=bias_value,
                   learning_rate_multiplier=lr2),
        ],
    }


def _pool(name, src, kernel=2, stride=2, mode="MAX"):
    return {"name": name, "type": "kPooling", "srclayers": src,
            "pooling_param": {"pool": mode, "kernel": kernel,
                              "stride": stride}}


def _ip(name, src, n, std=None, bias_value=0.0, lr2=2.0):
    winit = (dict(init_method="kGaussain", std=std) if std is not None
             else _FANIN)
    return {
        "name": name, "type": "kInnerProduct", "srclayers": src,
        "inner_product_param": {"num_output": n},
        "param": [
            _param("weight", **winit),
            _param("bias", init_method="kConstant", value=bias_value,
                   learning_rate_multiplier=lr2),
        ],
    }


def _relu(name, src):
    return {"name": name, "type": "kReLU", "srclayers": src}


def _lrn(name, src, local_size=5, alpha=1e-4, beta=0.75):
    return {"name": name, "type": "kLRN", "srclayers": src,
            "lrn_param": {"local_size": local_size, "alpha": alpha,
                          "beta": beta}}


def _dropout(name, src, ratio=0.5):
    return {"name": name, "type": "kDropout", "srclayers": src,
            "dropout_param": {"dropout_ratio": ratio}}


def _data_head(batchsize, parser="kRGBImage", rgb_scale=1.0, cropsize=0,
               mirror=True, mnist_norm=(255.0, 0.0)):
    layers: List[Dict] = [
        {"name": "data", "type": "kShardData",
         "data_param": {"batchsize": batchsize}},
        {"name": "label", "type": "kLabel", "srclayers": "data"},
    ]
    if parser == "kRGBImage":
        layers.insert(1, {
            "name": "rgb", "type": "kRGBImage", "srclayers": "data",
            "rgbimage_param": {"scale": rgb_scale, "cropsize": cropsize,
                               "mirror": mirror}})
        head = "rgb"
    else:
        layers.insert(1, {
            "name": "mnist", "type": "kMnistImage", "srclayers": "data",
            "mnist_param": {"norm_a": mnist_norm[0], "norm_b": mnist_norm[1]}})
        head = "mnist"
    return layers, head


def _loss(src, topk=1):
    return {"name": "loss", "type": "kSoftmaxLoss",
            "srclayers": [src, "label"],
            "softmaxloss_param": {"topk": topk}}


def alexnet_cifar10(batchsize: int = 128, train_steps: int = 10000,
                    lr: float = 0.001) -> ModelConfig:
    """Reduced AlexNet for CIFAR-10 (the classic 3-conv caffe variant the
    reference era used for this dataset): conv32-pool-relu-lrn ×2 swap,
    conv64, ip."""
    layers, head = _data_head(batchsize, "kRGBImage", rgb_scale=1 / 255.0)
    layers += [
        _conv("conv1", head, 32, 5, 1, 2, std=1e-4),
        _pool("pool1", "conv1", 3, 2),
        _relu("relu1", "pool1"),
        _lrn("norm1", "relu1", 3, 5e-5),
        _conv("conv2", "norm1", 32, 5, 1, 2, std=1e-2),
        _relu("relu2", "conv2"),
        _pool("pool2", "relu2", 3, 2, "AVE"),
        _lrn("norm2", "pool2", 3, 5e-5),
        _conv("conv3", "norm2", 64, 5, 1, 2, std=1e-2),
        _relu("relu3", "conv3"),
        _pool("pool3", "relu3", 3, 2, "AVE"),
        _ip("ip1", "pool3", 10, std=1e-2),
        _loss("ip1"),
    ]
    return model_config_from_dict({
        "name": "alexnet-cifar10",
        "train_steps": train_steps,
        "display_frequency": 100,
        "updater": {"type": "kSGD", "base_learning_rate": lr,
                    "momentum": 0.9, "weight_decay": 0.004,
                    "learning_rate_change_method": "kFixed"},
        "neuralnet": {"layer": layers},
    })


def alexnet_cifar10_full(batchsize: int = 1024, train_steps: int = 50000,
                         lr: float = 0.01) -> ModelConfig:
    """The actual 5-conv AlexNet stack (conv1-5 + LRN×2 + fc6-8) adapted
    to 32×32 CIFAR-10 input (stride-1 conv1, as in the standard CIFAR
    adaptation).  This — not the 3-conv caffe 'cifar10_quick' above — is
    the 'AlexNet on CIFAR-10' of the BASELINE gate and of
    examples/cifar10/alexnet.conf: 192-384 channel convs and 4096-wide
    fcs, with both LRNs after a ReLU (the fused K5/K6 path)."""
    layers, head = _data_head(batchsize, "kRGBImage", rgb_scale=1 / 255.0)
    layers += [
        _conv("conv1", head, 64, 5, 1, 2, std=1e-2),
        _relu("relu1", "conv1"),
        _lrn("norm1", "relu1", 5, 1e-4),
        _pool("pool1", "norm1", 3, 2),
        _conv("conv2", "pool1", 192, 5, 1, 2, std=1e-2, bias_value=1.0),
        _relu("relu2", "conv2"),
        _lrn("norm2", "relu2", 5, 1e-4),
        _pool("pool2", "norm2", 3, 2),
        _conv("conv3", "pool2", 384, 3, 1, 1, std=1e-2),
        _relu("relu3", "conv3"),
        _conv("conv4", "relu3", 256, 3, 1, 1, std=1e-2, bias_value=1.0),
        _relu("relu4", "conv4"),
        _conv("conv5", "relu4", 256, 3, 1, 1, std=1e-2, bias_value=1.0),
        _relu("relu5", "conv5"),
        _pool("pool5", "relu5", 3, 2),
        _ip("fc6", "pool5", 4096, std=5e-3, bias_value=1.0),
        _relu("relu6", "fc6"),
        _dropout("drop6", "relu6"),
        _ip("fc7", "drop6", 4096, std=5e-3, bias_value=1.0),
        _relu("relu7", "fc7"),
        _dropout("drop7", "relu7"),
        _ip("fc8", "drop7", 10, std=1e-2),
        _loss("fc8"),
    ]
    return model_config_from_dict({
        "name": "alexnet-cifar10-full",
        "train_steps": train_steps,
        "display_frequency": 100,
        "updater": {"type": "kSGD", "base_learning_rate": lr,
                    "momentum": 0.9, "weight_decay": 0.0005,
                    "learning_rate_change_method": "kStep", "gamma": 0.1,
                    "learning_rate_change_frequency": 20000},
        "neuralnet": {"layer": layers},
    })


def alexnet_imagenet(batchsize: int = 256, train_steps: int = 450000,
                     nclass: int = 1000) -> ModelConfig:
    """Full AlexNet (ImageNet-1k, single-tower): the reference BASELINE's
    'AlexNet on ImageNet-1k (data-parallel multi-worker)' config."""
    layers, head = _data_head(batchsize, "kRGBImage", cropsize=227)
    layers += [
        _conv("conv1", head, 96, 11, 4, 0, std=1e-2),
        _relu("relu1", "conv1"),
        _lrn("norm1", "relu1", 5, 1e-4),
        _pool("pool1", "norm1", 3, 2),
        _conv("conv2", "pool1", 256, 5, 1, 2, std=1e-2, bias_value=1.0),
        _relu("relu2", "conv2"),
        _lrn("norm2", "relu2", 5, 1e-4),
        _pool("pool2", "norm2", 3, 2),
        _conv("conv3", "pool2", 384, 3, 1, 1, std=1e-2),
        _relu("relu3", "conv3"),
        _conv("conv4", "relu3", 384, 3, 1, 1, std=1e-2, bias_value=1.0),
        _relu("relu4", "conv4"),
        _conv("conv5", "relu4", 256, 3, 1, 1, std=1e-2, bias_value=1.0),
        _relu("relu5", "conv5"),
        _pool("pool5", "relu5", 3, 2),
        _ip("fc6", "pool5", 4096, std=5e-3, bias_value=1.0),
        _relu("relu6", "fc6"),
        _dropout("drop6", "relu6"),
        _ip("fc7", "drop6", 4096, std=5e-3, bias_value=1.0),
        _relu("relu7", "fc7"),
        _dropout("drop7", "relu7"),
        _ip("fc8", "drop7", nclass, std=1e-2),
        _loss("fc8", topk=1),
    ]
    return model_config_from_dict({
        "name": "alexnet-imagenet",
        "train_steps": train_steps,
        "display_frequency": 20,
        "updater": {"type": "kSGD", "base_learning_rate": 0.01,
                    "momentum": 0.9, "weight_decay": 0.0005,
                    "learning_rate_change_method": "kStep", "gamma": 0.1,
                    "learning_rate_change_frequency": 100000},
        "neuralnet": {"layer": layers},
    })


def lenet_mnist(batchsize: int = 64, train_steps: int = 10000) -> ModelConfig:
    """The conv.conf LeNet, programmatic (same hyperparams)."""
    layers, head = _data_head(batchsize, "kMnistImage")
    layers += [
        _conv("conv1", head, 20, 5),
        _pool("pool1", "conv1", 2, 2),
        _conv("conv2", "pool1", 50, 5),
        _pool("pool2", "conv2", 2, 2),
        _ip("ip1", "pool2", 500),
        _relu("relu1", "ip1"),
        _ip("ip2", "relu1", 10),
        _loss("ip2"),
    ]
    return model_config_from_dict({
        "name": "lenet-mnist",
        "train_steps": train_steps,
        # test cadence mirrors the reference conv.conf:3-4
        "test_steps": 100, "test_frequency": 500,
        "display_frequency": 100,
        "updater": {"type": "kSGD", "base_learning_rate": 0.01,
                    "momentum": 0.9, "weight_decay": 0.0005,
                    "learning_rate_change_method": "kInverse",
                    "gamma": 0.0001, "pow": 0.75},
        "neuralnet": {"layer": layers},
    })


def mlp_mnist(batchsize: int = 1000, train_steps: int = 60000,
              widths=(2500, 2000, 1500, 1000, 500)) -> ModelConfig:
    """The mlp.conf deep MLP, programmatic."""
    layers, head = _data_head(batchsize, "kMnistImage",
                              mnist_norm=(127.5, 1.0))
    src = head
    for i, w in enumerate(widths, 1):
        layers.append({
            "name": f"fc{i}", "type": "kInnerProduct", "srclayers": src,
            "inner_product_param": {"num_output": w},
            "param": [_param("weight", **_UNIFORM),
                      _param("bias", **_UNIFORM)]})
        layers.append({"name": f"tanh{i}", "type": "kTanh",
                       "srclayers": f"fc{i}"})
        src = f"tanh{i}"
    layers.append({
        "name": f"fc{len(widths) + 1}", "type": "kInnerProduct",
        "srclayers": src, "inner_product_param": {"num_output": 10},
        "param": [_param("weight", **_UNIFORM), _param("bias", **_UNIFORM)]})
    layers.append(_loss(f"fc{len(widths) + 1}"))
    return model_config_from_dict({
        "name": "deep-big-simple-mlp",
        "train_steps": train_steps,
        # test cadence mirrors the reference mlp.conf:3-4
        "test_steps": 10, "test_frequency": 30,
        "display_frequency": 30,
        # the reference's mlp.conf runs the Elastic-averaging consistency
        # tier (mlp.conf:12-16): sync with the center every 8 steps
        # after 60 warmup steps — live through Trainer.run/ReplicaSet
        "updater": {"type": "kSGD", "base_learning_rate": 0.001,
                    "learning_rate_change_method": "kStep", "gamma": 0.997,
                    "learning_rate_change_frequency": 60,
                    "param_type": "Elastic", "sync_frequency": 8,
                    "moving_rate": 0.9, "warmup_steps": 60},
        "neuralnet": {"layer": layers},
    })
