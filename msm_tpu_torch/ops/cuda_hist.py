"""Kernel 3: bucket-count histogram of window keys, and its plain twin.

CUDA source: ``msm_tpu_torch/csrc/hist.cu``. Replaces the Pallas kernel
``msm_tpu/ops/pallas_hist.py::make_bucket_hist`` (``pallas_call`` at :83).
The TPU's one-hot MXU formulation was exact only below 2^24 keys; atomics
count exactly at any size. Each block counts a contiguous range of one
row's keys into counters in shared memory and flushes them with one global
atomic per non-zero counter; ``hist_plan`` sizes the blocks. The caller's
cumulative sum gives the bucket ends (``scan._counts_leq``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from msm_tpu_torch.ops import _build
from msm_tpu_torch.params import MsmConfig

HIST_THREADS = 1024  # block size of the kernel (csrc/hist.cu THREADS)
#: keys a block reads per counter it flushes, where the row is long enough
KEYS_PER_COUNTER = 3


@dataclass(frozen=True)
class HistPlan:
    """Launch plan of the histogram kernel: a grid of (blocks_per_row,
    groups, tiles) blocks; block (b, g, z) counts keys
    [b * key_chunk, (b + 1) * key_chunk) of row g that fall in buckets
    [z * bucket_tile, (z + 1) * bucket_tile)."""

    key_chunk: int
    blocks_per_row: int
    bucket_tile: int
    tiles: int
    threads: int = HIST_THREADS

    @property
    def smem_bytes(self) -> int:
        return 4 * self.bucket_tile


def hist_plan(groups: int, n: int, num_buckets: int) -> HistPlan:
    """Bucket tiles: as few as keep a tile's int32 counters within the
    shared memory a block may use. Blocks per row: one wave of resident
    blocks over the card, but no more than leave each block
    KEYS_PER_COUNTER keys per counter it flushes (at least one block)."""
    tiles = -(-4 * num_buckets // _build.SMEM_PER_BLOCK)
    tile = -(-num_buckets // tiles)
    resident = max(1, min(_build.THREADS_PER_SM // HIST_THREADS,
                          _build.SMEM_PER_SM // (4 * tile + _build.SMEM_RESERVED_PER_BLOCK)))
    per_row = max(1, min(_build.SMS * resident // (groups * tiles),
                         n // (KEYS_PER_COUNTER * tile)))
    keys = max(n, 1)
    chunk = -(-keys // per_row)
    return HistPlan(key_chunk=chunk, blocks_per_row=-(-keys // chunk), bucket_tile=tile, tiles=tiles)


def bucket_hist_plain(keys: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Plain twin: keys [G, n] in [0, num_buckets) -> counts [G, num_buckets]."""
    G = keys.shape[0]
    offs = torch.arange(G, device=keys.device, dtype=torch.int64)[:, None] * num_buckets
    flat = (keys.to(torch.int64) + offs).reshape(-1)
    counts = torch.bincount(flat, minlength=G * num_buckets)
    return counts.reshape(G, num_buckets).to(torch.int32)


def bucket_hist(cfg: MsmConfig, keys: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Counts of each bucket key per row: int32 [G, n] -> [G, num_buckets]."""
    if keys.device.type == "cpu":
        return bucket_hist_plain(keys, num_buckets)
    keys = keys.contiguous()
    _build.require_cuda(cfg, keys)
    G, n = keys.shape
    counts = torch.zeros((G, num_buckets), dtype=torch.int32, device=keys.device)
    plan = hist_plan(G, n, num_buckets)
    _build.launch("msm_hist", keys, counts, G, n, num_buckets, plan.key_chunk, plan.bucket_tile, width=cfg.word_size)
    bucket_hist.launches += 1
    return counts


bucket_hist.launches = 0
