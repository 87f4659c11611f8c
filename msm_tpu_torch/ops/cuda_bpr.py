"""Kernel 8: phase 1 of the blocked bucket reduction, and its plain twin.

CUDA source: ``msm_tpu_torch/csrc/bpr.cu`` (chain body in
``csrc/bpr.cuh``, on the word core: a group of lanes per chain; kernel and
launch in ``csrc/offpath.cuh``), for every curve of ``params.CURVES``. Replaces
the Pallas kernel ``msm_tpu/ops/pallas_bpr.py::make_bpr_phase1``
(``pallas_call`` at :97).

Buckets arrive step-major with a leading subtask axis, ``[G, Bl, T, L]``
x3: lane t of subtask g owns the Bl buckets ``[g, :, t]`` and walks them
from the top down, ``m <- m + B[g, b, t]``, ``acc <- acc + m``. Returns
``(mx, my, mz, gx, gy, gz)``, each ``[G, T, L]``: m the block sums, g the
sums of the running sums. The kernel writes canonical limbs, the twin
balanced ones; compare after ``canonical``.
"""

from __future__ import annotations

import torch

from msm_tpu_torch.ops import _build
from msm_tpu_torch.params import MsmConfig


def bpr_phase1_plain(cfg: MsmConfig, bx, by, bz):
    """Plain twin: the same descending walk with the plain addition,
    batched over [G, T]."""
    from msm_tpu_torch.ops.cuda_curve import point_add_plain
    from msm_tpu_torch.ops.curve import get_curve_ctx

    G, Bl, T, _ = bx.shape
    m = acc = tuple(get_curve_ctx(cfg).identity((G, T), bx.device))
    for b in range(Bl - 1, -1, -1):
        m = point_add_plain(cfg, *m, bx[:, b], by[:, b], bz[:, b])
        acc = point_add_plain(cfg, *acc, *m)
    return (*m, *acc)


def bpr_phase1(cfg: MsmConfig, bx, by, bz):
    """(m, g) of every lane: [G, Bl, T, L] x3 -> six [G, T, L]."""
    if bx.device.type == "cpu":
        return bpr_phase1_plain(cfg, bx, by, bz)
    ins = _build.aligned(bx, by, bz)
    _build.require_cuda(cfg, *ins)
    G, Bl, T, L = ins[0].shape
    for t in ins:
        if t.shape != (G, Bl, T, L) or L != cfg.num_words:
            raise ValueError(f"expected [G, Bl, T, {cfg.num_words}] inputs, got {tuple(t.shape)}")
    out = [torch.empty((G, T, L), dtype=torch.int32, device=bx.device) for _ in range(6)]
    _build.launch("msm_bpr_phase1", *ins, *out, G, Bl, T, _build.curve_id(cfg), width=cfg.word_size)
    bpr_phase1.launches += 1
    return tuple(out)


bpr_phase1.launches = 0
