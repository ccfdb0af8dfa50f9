"""RBM and autoencoder pretraining: the kContrastiveDivergence path.

Port of `singa_tpu/models/rbm.py`.  The reference declares
GradCalcAlg::kContrastiveDivergence (model.proto:40-44) and never
implemented a CD worker; the JAX package runs the CD-k Gibbs chain
(binary units, sigmoid activations) in one jitted step.  Here the chain
is a loop of tensor ops with no host sync, so the trainer captures it
into a CUDA graph (`Trainer.run_cd`).

Bernoulli draws are `u < p` over uniforms u, as `jax.random.bernoulli`
draws them; the uniforms come from a source passed in (a
`torch.Generator` on the main path; the tests inject JAX's), taken per
Gibbs step as the hidden units' and then the visible units'.

Greedy stacking follows Hinton and Salakhutdinov (2006): RBM i trains on
the hidden probabilities of RBM i-1, and the stack unrolls into a deep
autoencoder with tied transposed decoder weights.

The kRBM layer registers when this module is imported;
`core.layers.create_layer` imports it on its first unknown layer type,
as the JAX package registers kRBM lazily (`singa_tpu/core/layers.py:
605-609`).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..core.layers import Layer, LayerError, register_layer
from ..core.seq_layers import _declare_with_default

Params = Dict[str, torch.Tensor]
# a uniform source: a generator, or a callable shape → U[0, 1) tensor
Uniform = Union[torch.Generator, Callable[[Tuple[int, ...]], torch.Tensor]]


def init_rbm(gen: torch.Generator, nvis: int, nhid: int,
             std: float = 0.01) -> Params:
    """{W (nvis, nhid) ~ N(0, std²), bv, bh zeros} on the generator's
    device."""
    dev = gen.device
    return {
        "W": std * torch.randn((nvis, nhid), generator=gen, device=dev),
        "bv": torch.zeros((nvis,), device=dev),
        "bh": torch.zeros((nhid,), device=dev),
    }


def _h_prob(params: Params, v: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(v @ params["W"] + params["bh"])


def _v_prob(params: Params, h: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(h @ params["W"].T + params["bv"])


def free_energy(params: Params, v: torch.Tensor) -> torch.Tensor:
    """F(v) = -v·bv - Σ softplus(vW + bh)."""
    return (-v @ params["bv"]
            - torch.sum(torch.nn.functional.softplus(
                v @ params["W"] + params["bh"]), dim=-1))


def _uniform_fn(rng: Uniform, device) -> Callable:
    if isinstance(rng, torch.Generator):
        return lambda shape: torch.rand(shape, generator=rng, device=device)
    return rng


def cd_grads(params: Params, v0: torch.Tensor, rng: Uniform, k: int = 1,
             persistent: Optional[torch.Tensor] = None
             ) -> Tuple[Params, torch.Tensor, torch.Tensor]:
    """CD-k gradients: (grads, reconstruction error, chain end).

    The grads follow the descent convention (params -= lr·grad), so they
    go to the updater as they are.  `persistent` (PCD) starts the Gibbs
    chain; None starts it from the data batch `v0`.  `rng` gives the
    uniforms of the Bernoulli draws."""
    uniform = _uniform_fn(rng, v0.device)
    b = v0.shape[0]
    h0_prob = _h_prob(params, v0)
    v = persistent if persistent is not None else v0
    v_prob = v
    for _ in range(k):
        h_prob = _h_prob(params, v)
        h = (uniform(tuple(h_prob.shape)) < h_prob).float()
        v_prob = _v_prob(params, h)
        v = (uniform(tuple(v_prob.shape)) < v_prob).float()
    hk_prob = _h_prob(params, v_prob)
    # <v0 h0> - <vk hk>, sign-flipped to the descent convention
    gW = -(v0.T @ h0_prob - v_prob.T @ hk_prob) / b
    gbv = -torch.mean(v0 - v_prob, dim=0)
    gbh = -torch.mean(h0_prob - hk_prob, dim=0)
    recon = torch.mean(torch.square(v0 - _v_prob(params, h0_prob)))
    return {"W": gW, "bv": gbv, "bh": gbh}, recon, v


@torch.no_grad()
def pretrain_rbm(gen: torch.Generator, data_iter, nvis: int, nhid: int,
                 steps: int = 1000, lr: float = 0.1, k: int = 1,
                 momentum: float = 0.5, log_every: int = 0,
                 log_fn=print) -> Params:
    """Train one RBM with CD-k and momentum SGD on data in [0, 1]: the
    weights from `gen`, then each step's chain from it too."""
    params = init_rbm(gen, nvis, nhid)
    vel = {k_: torch.zeros_like(p) for k_, p in params.items()}
    for step in range(steps):
        v0 = next(data_iter)
        grads, recon, _ = cd_grads(params, v0, gen, k=k)
        for name in params:
            vel[name] = momentum * vel[name] + lr * grads[name]
            params[name] = params[name] - vel[name]
        if log_every and step % log_every == 0:
            log_fn(f"rbm step-{step}: recon {float(recon):.5f}")
    return params


def greedy_pretrain(gen: torch.Generator, data_factory,
                    widths: Sequence[int], nvis: int,
                    steps_per_layer: int = 1000, lr: float = 0.1,
                    k: int = 1, log_fn=print) -> List[Params]:
    """Stack RBMs greedily: each trained on the previous layer's hidden
    probabilities."""
    rbms: List[Params] = []
    sizes = [nvis] + list(widths)

    def lifted_iter():
        it = data_factory()
        while True:
            v = next(it)
            for p in rbms:
                v = _h_prob(p, v)
            yield v

    for i, (nv, nh) in enumerate(zip(sizes[:-1], sizes[1:])):
        log_fn(f"pretraining RBM {i}: {nv} -> {nh}")
        rbms.append(pretrain_rbm(gen, lifted_iter(), nv, nh,
                                 steps_per_layer, lr, k))
    return rbms


def unroll_autoencoder(rbms: List[Params]) -> Params:
    """Unroll stacked RBMs into deep-autoencoder params: encoder layers
    enc_i/{weight,bias} and tied decoder layers dec_i/{weight,bias}
    (decoder weight = encoder transpose)."""
    params = {}
    n = len(rbms)
    for i, p in enumerate(rbms):
        params[f"enc{i}/weight"] = p["W"]
        params[f"enc{i}/bias"] = p["bh"]
        params[f"dec{n - 1 - i}/weight"] = p["W"].T
        params[f"dec{n - 1 - i}/bias"] = p["bv"]
    return params


def autoencoder_apply(params: Params, v: torch.Tensor,
                      nlayers: int) -> torch.Tensor:
    """Forward through the unrolled autoencoder (sigmoid units); the
    reconstruction is differentiable, for fine-tuning."""
    h = v
    for i in range(nlayers):
        h = torch.sigmoid(h @ params[f"enc{i}/weight"]
                          + params[f"enc{i}/bias"])
    for i in range(nlayers):
        h = torch.sigmoid(h @ params[f"dec{i}/weight"]
                          + params[f"dec{i}/bias"])
    return h


# ---------------------------------------------------------------------------
# the config surface: the kRBM layer (training: Trainer.run_cd)


@register_layer("kRBM")
class RBMLayer(Layer):
    """Restricted Boltzmann machine layer (RBMProto: num_hidden, cd_k,
    persistent).  The forward is the hidden units' probabilities
    sigmoid(vW + bh), the deterministic pass used for greedy stacking
    and by the layers above; training runs the CD-k chain through
    `Trainer.run_cd` (ModelProto.alg), not backprop.  Params `weight`
    (nvis, nhid), `vbias`, `hbias`: N(0, 0.01²), 0 and 0 unless the
    config gives a ParamProto, as the JAX layer declares them."""

    is_rbm = True

    def setup(self, src_shapes):
        p = self.cfg.rbm_param
        if p is None or not p.num_hidden:
            raise LayerError(f"{self.name}: rbm_param.num_hidden required")
        s = tuple(src_shapes[0])
        self.nvis = 1
        for d in s[1:]:
            self.nvis *= d
        self.nhid = p.num_hidden
        self.cd_k = max(p.cd_k, 1)
        self.persistent = p.persistent
        self.out_shape = (s[0], self.nhid)
        self.w_key = _declare_with_default(
            self, 0, "weight", (self.nvis, self.nhid), 0.01)
        self.bv_key = _declare_with_default(self, 1, "vbias", (self.nvis,),
                                            0.0)
        self.bh_key = _declare_with_default(self, 2, "hbias", (self.nhid,),
                                            0.0)

    def cd_view(self, params) -> Params:
        """{W, bv, bh} view for cd_grads."""
        return {"W": params[self.w_key], "bv": params[self.bv_key],
                "bh": params[self.bh_key]}

    def named_grads(self, cd: Params) -> Params:
        return {self.w_key: cd["W"], self.bv_key: cd["bv"],
                self.bh_key: cd["bh"]}

    def apply(self, params, srcs, ctx):
        v = srcs[0].reshape(srcs[0].shape[0], -1)
        view = self.cd_view(params)
        return _h_prob(view, v.to(view["W"].dtype))


def rbm_mnist(widths: Sequence[int] = (250, 100), batchsize: int = 64,
              train_steps: int = 2000, lr: float = 0.1, cd_k: int = 1):
    """Config for greedy RBM pretraining on MNIST-shaped data
    (alg: kContrastiveDivergence), as `examples/mnist/rbm.conf`."""
    from ..config.schema import model_config_from_dict
    layers = [
        {"name": "data", "type": "kShardData",
         "data_param": {"batchsize": batchsize}},
        {"name": "mnist", "type": "kMnistImage", "srclayers": "data",
         "mnist_param": {"norm_a": 255.0}},
    ]
    src = "mnist"
    for i, w in enumerate(widths):
        layers.append({"name": f"rbm{i}", "type": "kRBM",
                       "srclayers": src,
                       "rbm_param": {"num_hidden": w, "cd_k": cd_k}})
        src = f"rbm{i}"
    return model_config_from_dict({
        "name": "rbm-mnist", "train_steps": train_steps,
        "display_frequency": 100,
        "alg": "kContrastiveDivergence",
        "updater": {"type": "kSGD", "base_learning_rate": lr,
                    "momentum": 0.5,
                    "learning_rate_change_method": "kFixed"},
        "neuralnet": {"layer": layers}})
