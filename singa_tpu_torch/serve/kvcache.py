"""Paged KV cache: a fixed pool of key/value blocks shared by every
serving slot, with host-side block tables and refcounts.

Port of `singa_tpu/serve/kvcache.py`.  Every kAttention layer owns one
(num_blocks, Hkv, block_len, D) pool per side, a slot holds an ordered
list of block indices (its *block table* row), and retiring a slot
returns its blocks to the free list at once, so slot memory is
O(active tokens) where the bucket path's contiguous cache is
O(max_len) per row.

  * device side (torch tensors in `pools`, on the engine's device) —
    written in place and read only by the engine's two continuous-
    batching programs (`models.generate.forward_paged` /
    `scatter_prefill`), CUDA graphs on the card that were captured
    over these very tensors.  Block 0 is a reserved NULL block:
    inactive slots and table-tail entries point at it, so masked
    writes/reads land somewhere harmless and the programs never need a
    "no block" special case.
  * host side (this class) — free list, per-block refcounts and the
    (num_slots, max_blocks_per_slot) int32 block table, plain numpy
    under the scheduler's single thread.

Blocks are reserved *conservatively at admission*: the scheduler asks
for ceil((plen + max_new) / block_len) blocks up front, so pool
exhaustion can only ever surface as an admission decision (queue, then
shed), never as a mid-decode OOM or a deadlock between half-admitted
requests.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

Pools = Dict[str, Dict[str, torch.Tensor]]   # layer -> {"k","v"} pools

NULL_BLOCK = 0


def _attention_layers(net):
    return [net.layers[n] for n in net.topo
            if net.layers[n].cfg.type == "kAttention"]


def init_pools(net, num_blocks: int, block_len: int,
               dtype=torch.float32, device: DeviceLike = None) -> Pools:
    """Zeroed (num_blocks, Hkv, block_len, D) k/v pools for every
    kAttention layer (the paged sibling of `generate.init_cache`), on
    `device` (CUDA unless the caller passes device='cpu')."""
    dev = resolve_device(device)
    pools: Pools = {}
    for layer in _attention_layers(net):
        shape = (num_blocks, layer.kv_heads, block_len, layer.head_dim)
        pools[layer.name] = {
            "k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}
    return pools


def pool_bytes(net, num_blocks: int, block_len: int,
               dtype=torch.float32) -> int:
    """Byte count of the pools `init_pools` allocates — k and v per
    kAttention layer, (num_blocks, Hkv, block_len, D) each."""
    elems = sum(2 * num_blocks * layer.kv_heads * block_len
                * layer.head_dim for layer in _attention_layers(net))
    return elems * torch.empty((), dtype=dtype).element_size()


class PagedKVCache:
    """Block pool + slot tables for one serving engine.  Single-owner:
    the `ContinuousScheduler` thread is the only mutator, so the
    bookkeeping needs no lock; `snapshot()` reads are approximate from
    other threads (ints are swapped atomically in CPython)."""

    def __init__(self, net, num_slots: int, max_blocks_per_slot: int,
                 num_blocks: int, block_len: int, dtype=torch.float32,
                 device: DeviceLike = None, pools: Optional[Pools] = None):
        """`pools`, when given, are adopted instead of allocated: the
        engine's, which its captured programs read and write (they must
        have this geometry)."""
        if num_blocks < 2:
            raise ValueError(f"num_blocks must be >= 2 (block 0 is the "
                             f"reserved null block), got {num_blocks}")
        if block_len < 1 or num_slots < 1 or max_blocks_per_slot < 1:
            raise ValueError("num_slots, max_blocks_per_slot and "
                             "block_len must all be >= 1")
        self.num_slots = int(num_slots)
        self.max_blocks_per_slot = int(max_blocks_per_slot)
        self.num_blocks = int(num_blocks)
        self.block_len = int(block_len)
        if pools is None:
            pools = init_pools(net, self.num_blocks, self.block_len,
                               dtype, device)
        for name, entry in pools.items():
            if entry["k"].shape[0] != self.num_blocks or \
                    entry["k"].shape[2] != self.block_len:
                raise ValueError(
                    f"pool {name} has shape {tuple(entry['k'].shape)}, "
                    f"not ({self.num_blocks}, Hkv, {self.block_len}, D)")
        self.pools: Pools = pools
        # host bookkeeping: block 0 never enters the free list
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._refcounts = np.zeros((self.num_blocks,), np.int32)
        self.tables = np.full((self.num_slots, self.max_blocks_per_slot),
                              NULL_BLOCK, np.int32)
        self._slot_blocks: Dict[int, List[int]] = {}

    # -- capacity -----------------------------------------------------------
    @property
    def usable_blocks(self) -> int:
        """Pool capacity excluding the null block."""
        return self.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def blocks_in_use(self) -> int:
        return self.usable_blocks - len(self._free)

    def blocks_for(self, total_tokens: int) -> int:
        """Blocks a sequence of `total_tokens` (prompt + generated)
        needs — the conservative admission reservation."""
        return -(-max(int(total_tokens), 1) // self.block_len)

    def can_admit(self, nblocks: int) -> bool:
        return nblocks <= len(self._free)

    # -- slot lifecycle -----------------------------------------------------
    def alloc(self, slot: int, nblocks: int) -> np.ndarray:
        """Reserve `nblocks` blocks for `slot` (refcount 1 each) and
        return the slot's full table row (real blocks first, null
        padding after).  Raises RuntimeError when the pool cannot
        cover the reservation — the scheduler checks `can_admit`
        first, so reaching the raise is a bug, not backpressure."""
        if slot in self._slot_blocks:
            raise RuntimeError(f"slot {slot} already holds blocks")
        if nblocks > self.max_blocks_per_slot:
            raise ValueError(
                f"request needs {nblocks} blocks but a slot holds at "
                f"most {self.max_blocks_per_slot}")
        if nblocks > len(self._free):
            raise RuntimeError(
                f"block pool exhausted: need {nblocks}, "
                f"{len(self._free)} free")
        blocks = [self._free.pop() for _ in range(nblocks)]
        self._refcounts[blocks] += 1
        self.tables[slot] = NULL_BLOCK
        self.tables[slot, :nblocks] = blocks
        self._slot_blocks[slot] = blocks
        return self.tables[slot].copy()

    def free(self, slot: int) -> None:
        """Retire `slot`: drop each block's refcount and return
        zero-refcount blocks to the free list immediately."""
        blocks = self._slot_blocks.pop(slot, None)
        if blocks is None:
            return
        for b in blocks:
            self._refcounts[b] -= 1
            if self._refcounts[b] == 0:
                self._free.append(b)
        self.tables[slot] = NULL_BLOCK

    def free_all(self) -> None:
        for slot in list(self._slot_blocks):
            self.free(slot)

    # -- reads --------------------------------------------------------------
    def table_array(self) -> np.ndarray:
        """Copy of the (num_slots, max_blocks_per_slot) int32 block
        table for upload to the decode program."""
        return self.tables.copy()

    def utilization(self) -> float:
        return (self.blocks_in_use / self.usable_blocks
                if self.usable_blocks else 0.0)

    def snapshot(self) -> Dict[str, Any]:
        return {"num_blocks": self.num_blocks,
                "usable_blocks": self.usable_blocks,
                "free_blocks": self.free_blocks,
                "blocks_in_use": self.blocks_in_use,
                "block_len": self.block_len,
                "num_slots": self.num_slots,
                "max_blocks_per_slot": self.max_blocks_per_slot,
                "utilization": round(self.utilization(), 4)}
