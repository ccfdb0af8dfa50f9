"""Sequence parallelism: ring attention and Ulysses.

Port of `singa_tpu/parallel/sequence.py`.  The JAX package runs each as
a `shard_map` over the mesh; here each rank calls the function on its
own shard, and the seq axis's collectives (`parallel/comm.py`) stand
for `jax.lax.ppermute` and `jax.lax.all_to_all`.  A rank holds the
(B, H, S/n, D) chunk of q, k and v at its seq index (the batch rows of
its data index, and with a model axis the heads of its model index,
which the column-parallel projections of kAttention already leave it).

- **Ring attention**: KV rotates around the seq ring at Hkv width and
  is expanded to the local q heads on the local chunk only; partial
  results merge in log-sum-exp space (`ops.attention.merge_attention`).
  With the flash local step, a causal rotation is diagonal (the causal
  kernel), fully visible (the non-causal kernel) or fully masked (zeros
  and NEG_INF: no launch), decided per rank from its seq index; chunks
  the kernels do not tile take `chunk_attention_blockwise` with
  absolute-position masks.
- **Ulysses**: two all-to-alls re-shard seq → heads, the strided flash
  kernel (or the dense reference) runs on H/n heads at full S, and the
  output is re-sharded back.  KV travels at Hkv width where it splits
  over the axis as q's heads do.

Both go through K1 forward and K3/K4 backward on the card (their plain
versions on the CPU), the ring's with a nonzero lse cotangent.  The JAX
package's third route, `packed_attention_sharded` (the packed kernels
on a model rank's heads), is `ops.attention.flash_attention_packed`
here: a rank's column-parallel projections already hold just its heads.
"""

from __future__ import annotations

import torch

from ..ops import attention as A
from .comm import AxisGroup, all_to_all, ring_rotations


def ring_attention(q, k, v, group: AxisGroup, causal: bool = True
                   ) -> torch.Tensor:
    """q: this rank's (B, H, S/n, D) chunk; k, v: (B, Hkv, S/n, D) with
    Hkv dividing H (GQA).  Returns this rank's chunk of the output, in
    q's dtype.  With a seq axis of 1 it is whole-sequence attention on
    the expanded kv: the JAX package returns its dense
    `attention_reference` there (`:113-115`); the port takes the
    strided flash kernels where they tile, the same function."""
    nseq = group.n
    h = q.shape[1]
    chunk, d = q.shape[2], q.shape[3]
    if nseq == 1:
        attend = (A.flash_attention if A.flash_legal(chunk, d)
                  else A.attention_reference)
        return attend(q, A.expand_kv_heads(k, h), A.expand_kv_heads(v, h),
                      causal)
    use_flash = A.flash_chunk_legal(chunk, chunk, d)
    idx = group.index
    # every rotation of kv, as one node: each rank runs the same
    # collectives forward and backward whichever rotations it uses
    kvs = ring_rotations(torch.stack([k, v]), group)
    out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.full(q.shape[:3] + (1,), A.NEG_INF, dtype=torch.float32,
                     device=q.device)
    _, block_k = A.flash_blocks(chunk)
    for s, kv in enumerate(kvs):
        src = (idx - s) % nseq          # the owner of this kv chunk
        kk, vv = A.expand_kv_heads(kv[0], h), A.expand_kv_heads(kv[1], h)
        if not use_flash:
            o_new, l_new = A.chunk_attention_blockwise(
                q, kk, vv, causal, idx * chunk, src * chunk, block_k)
        elif not causal:
            o_new, l_new = A.flash_chunk(q, kk, vv, False)
        elif s == 0:                    # diagonal: kv_off == q_off
            o_new, l_new = A.flash_chunk(q, kk, vv, True)
        elif idx >= s:                  # strictly earlier: all visible
            o_new, l_new = A.flash_chunk(q, kk, vv, False)
        else:                           # strictly later: all masked
            continue
        out, lse = A.merge_attention(out, lse, o_new, l_new)
    return out.to(q.dtype)


def ulysses_attention(q, k, v, group: AxisGroup, causal: bool = True
                      ) -> torch.Tensor:
    """Ulysses on this rank's chunks (shapes as `ring_attention`): an
    all-to-all to (B, H/n, S, D), the strided flash kernel (the dense
    reference where S and D do not tile), and an all-to-all back.  H
    must divide by the seq axis; kv keeps Hkv width where Hkv divides
    too, else it is expanded first."""
    nseq = group.n
    h, hkv = q.shape[1], k.shape[1]
    s_global, d = q.shape[2] * nseq, q.shape[3]
    attend = (A.flash_attention
              if A.flash_chunk_legal(s_global, s_global, d)
              else A.attention_reference)
    if nseq == 1:
        return attend(q, A.expand_kv_heads(k, h), A.expand_kv_heads(v, h),
                       causal)
    if h % nseq:
        raise ValueError(f"Ulysses needs heads ({h}) % seq axis ({nseq}) "
                         f"== 0")
    if hkv != h and hkv % nseq:
        k, v = A.expand_kv_heads(k, h), A.expand_kv_heads(v, h)
    qh, kh, vh = all_to_all([q, k, v], 1, 2, group)
    if kh.shape[1] != qh.shape[1]:
        kh = A.expand_kv_heads(kh, qh.shape[1])
        vh = A.expand_kv_heads(vh, qh.shape[1])
    out = attend(qh, kh, vh, causal)
    return all_to_all([out], 2, 1, group)[0]
