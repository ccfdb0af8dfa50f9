"""K1's plain version and the attention helpers of the PyTorch port
against the JAX package: the interpret-mode packed flash kernel, the
strided flash route, the dense reference, RoPE and GQA expansion.

Inputs are made with numpy from a seed and handed to both sides in f32.
Tolerance rtol 1e-4, atol 1e-5 (as tests/test_sequence.py:45-46): the
two sides sum the same online softmax in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.ops import attention as jattn
from singa_tpu_torch.ops import attention as tattn

pytestmark = pytest.mark.port
RTOL, ATOL = 1e-4, 1e-5


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# 96: a head dim the kernel pads to its 128-wide tile
@pytest.mark.parametrize("d", [16, 32, 96])
@pytest.mark.parametrize("heads,kv_heads", [(4, 4), (4, 2)])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_k1_matches_interpret_kernel(causal, heads, kv_heads, d):
    b, s = 2, 256
    q, k, v = _arrays(heads * 10 + d + causal, (b, s, heads * d),
                      (b, s, kv_heads * d), (b, s, kv_heads * d))
    out_j, lse_j = jattn.flash_attention_packed_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads, causal,
        128, 128, True, kv_heads)
    out_t, lse_t = tattn.flash_forward_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        heads, causal, kv_heads)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j),
                               rtol=RTOL, atol=ATOL)


def test_wrapper_takes_plain_version_on_cpu():
    """A CPU tensor runs the plain version, and no kernel is counted."""
    from singa_tpu_torch.ops import _kernels
    q, k, v = (torch.from_numpy(a) for a in _arrays(
        1, (1, 128, 64), (1, 128, 32), (1, 128, 32)))
    before = dict(_kernels.LAUNCHES)
    out, lse = tattn.flash_attention_packed_lse(q, k, v, 4, True, 2)
    ref_out, ref_lse = tattn.flash_forward_plain(q, k, v, 4, True, 2)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    assert _kernels.LAUNCHES == before
    with pytest.raises(ValueError):
        tattn.flash_attention_packed_lse(q, k[..., :16], v, 4, True, 2)


@pytest.mark.parametrize("causal", [False, True])
def test_strided_flash_matches_jax_reference(causal):
    q, k, v = _arrays(7, (2, 4, 256, 32), (2, 4, 256, 32), (2, 4, 256, 32))
    ref = jattn.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal)
    out = tattn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_reference_matches_jax(causal):
    q, k, v = _arrays(8, (2, 2, 40, 16), (2, 2, 40, 16), (2, 2, 40, 16))
    ref = jattn.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal)
    out = tattn.attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def test_rope_and_gqa_helpers_match_jax():
    x, xp, kv = _arrays(9, (2, 4, 24, 16), (2, 24, 64), (2, 2, 24, 16))
    pos = np.arange(5, 29)
    np.testing.assert_allclose(
        tattn.rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy(),
        np.asarray(jattn.rope(jnp.asarray(x), jnp.asarray(pos))),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        tattn.rope_packed(torch.from_numpy(xp), torch.from_numpy(pos),
                          4).numpy(),
        np.asarray(jattn.rope_packed(jnp.asarray(xp), jnp.asarray(pos), 4)),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(
        tattn.expand_kv_heads(torch.from_numpy(kv), 4).numpy(),
        np.asarray(jattn.expand_kv_heads(jnp.asarray(kv), 4)))


def test_flash_route_rule_matches_jax():
    for s, d in [(128, 64), (256, 8), (16, 64), (130, 64), (128, 12)]:
        want = s % 128 == 0 and d % 8 == 0          # seq_layers.py:256
        assert tattn.flash_legal(s, d) == want
        assert jattn.flash_chunk_legal(s, s, d) or not want
