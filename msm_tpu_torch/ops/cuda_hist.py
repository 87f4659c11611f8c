"""Kernel 3: bucket-count histogram of window keys, and its plain twin.

CUDA source: ``msm_tpu_torch/csrc/hist.cu``. Replaces the Pallas kernel
``msm_tpu/ops/pallas_hist.py::make_bucket_hist`` (``pallas_call`` at :83).
The TPU's one-hot MXU formulation was exact only below 2^24 keys; atomics
count exactly at any size. The caller's cumulative sum gives the bucket
ends (``scan._counts_leq``).
"""

from __future__ import annotations

import torch

from msm_tpu_torch.ops import _build
from msm_tpu_torch.params import MsmConfig


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
    _build.launch("msm_hist", keys, counts, G, n, num_buckets)
    bucket_hist.launches += 1
    return counts


bucket_hist.launches = 0
