"""The port's LRN (singa_tpu_torch/ops/lrn.py) against the TPU kernels
themselves: the plain versions of K5 and K6 — what the CUDA kernels
compute, and what a CPU tensor runs — against `lrn_fwd_pallas` and
`lrn_bwd_pallas` in interpret mode (as tests/test_ops.py:350-372 runs
them), gradients through the port's `_LRN` Function against `jax.vjp` of
`_lrn_nhwc(..., "interpret")`, and ragged shapes the TPU kernels do not
take against the port's NCHW oracle.

Tolerances, each with its reason:
- f32: atol 1e-5 — the same f32 steps, window sums in another order;
- bf16: one bf16 ulp of the largest |value| — both sides round the same
  f32 values to bf16, which may land one ulp apart where the f32 sums
  differ in their last bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.ops.lrn import _lrn_nhwc
from singa_tpu.ops.lrn_pallas import lrn_bwd_pallas, lrn_fwd_pallas

from singa_tpu_torch.ops import lrn as tlrn

pytestmark = pytest.mark.port
ALPHA, KNORM = 0.5, 1.0     # a normalisation far from the identity
# (local_size, beta) pairs per relu setting: all four combinations of
# L in {3, 5} and beta in {0.75, 0.5} over the two settings, and the
# wider windows L = 7 and 9, whose half-window passes 2 channels
WINDOWS = {False: ((3, 0.75), (5, 0.5), (7, 0.75)),
           True: ((3, 0.5), (5, 0.75), (9, 0.75))}


def _bf16_ulp(top: float) -> float:
    return 2.0 ** (np.floor(np.log2(top)) - 7)


def _close(got: torch.Tensor, want, dtype) -> None:
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        tol = _bf16_ulp(float(np.abs(want).max()))
        assert np.abs(got - want).max() <= tol, (np.abs(got - want).max(),
                                                 tol)


def _inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    return (jnp.asarray(x, jd), jnp.asarray(g, jd),
            torch.from_numpy(x).to(td), torch.from_numpy(g).to(td))


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(128, 4, 4, 8), (128, 3, 3, 16),
                                   (128, 2, 2, 64), (128, 1, 2, 192)])
def test_plain_k5_k6_match_the_pallas_kernels(shape, dtype, relu):
    """C = 64 and 192 are AlexNet's channel counts, the ones the CUDA
    kernels' vector route meets on the main path."""
    jx, jg, tx, tg = _inputs(shape, dtype, seed=sum(shape) + relu)
    for local_size, beta in WINDOWS[relu]:
        args = (local_size, ALPHA, beta, KNORM, relu)
        _close(tlrn.lrn_fwd_plain(tx, *args),
               lrn_fwd_pallas(jx, *args, interpret=True), dtype)
        _close(tlrn.lrn_bwd_plain(tx, tg, *args),
               lrn_bwd_pallas(jx, jg, *args, interpret=True), dtype)


@pytest.mark.parametrize("relu", [False, True])
def test_gradient_through_lrn_function_matches_jax_vjp(relu):
    jx, jg, tx, tg = _inputs((128, 4, 4, 8), "float32", seed=7 + relu)
    args = (3, ALPHA, 0.75, KNORM, relu)
    y_j, vjp = jax.vjp(lambda t: _lrn_nhwc(t, *args, "interpret"), jx)
    tx.requires_grad_(True)
    y_t = tlrn.relu_lrn(tx, *args)
    (dx_t,) = torch.autograd.grad(y_t, tx, tg)
    _close(y_t.detach(), y_j, "float32")
    _close(dx_t, vjp(jg)[0], "float32")


@pytest.mark.parametrize("relu", [False, True])
def test_ragged_shapes_match_the_nchw_oracle(relu):
    """N=3, C=13 (the TPU kernels need N % 128 == 0 and C % 8 == 0):
    forward against the NCHW oracle of relu(x), backward against
    autograd through that oracle."""
    rng = np.random.default_rng(11 + relu)
    x = torch.from_numpy(rng.standard_normal((3, 5, 6, 13))
                         .astype(np.float32)).requires_grad_(True)
    g = torch.from_numpy(rng.standard_normal((3, 5, 6, 13))
                         .astype(np.float32))
    args = (3, ALPHA, 0.5, KNORM)
    a = torch.relu(x) if relu else x
    want = tlrn.lrn(a.permute(0, 3, 1, 2), *args).permute(0, 2, 3, 1)
    (want_dx,) = torch.autograd.grad(want, x, g)
    got = tlrn.relu_lrn(x, *args, relu=relu)
    (got_dx,) = torch.autograd.grad(got, x, g)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_dx.numpy(), want_dx.numpy(), rtol=0,
                               atol=1e-5)


def test_nchw_oracle_matches_jax():
    from singa_tpu.ops.lrn import lrn as jlrn
    x = np.random.default_rng(3).standard_normal((2, 13, 4, 5)) \
        .astype(np.float32)
    for local_size, beta in ((3, 0.75), (5, 0.5)):
        np.testing.assert_allclose(
            tlrn.lrn(torch.from_numpy(x), local_size, ALPHA, beta).numpy(),
            np.asarray(jlrn(jnp.asarray(x), local_size, ALPHA, beta)),
            rtol=1e-6, atol=1e-6)


def test_even_local_size_raises():
    x = torch.zeros((1, 2, 2, 4))
    for fn in (lambda: tlrn.lrn_fwd(x, 4, 1.0, 0.75, 1.0, False),
               lambda: tlrn.lrn_bwd(x, x, 2, 1.0, 0.75, 1.0, True),
               lambda: tlrn.lrn(x, 4)):
        with pytest.raises(ValueError, match="odd"):
            fn()
