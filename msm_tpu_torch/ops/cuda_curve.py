"""Kernel 1: batched complete point addition, and its plain twin.

CUDA source: ``msm_tpu_torch/csrc/point_add.cu`` + ``point_add.cuh`` on the
32-bit-word core ``csrc/fe32.cuh`` + ``csrc/curve32.cuh``, generic over the
curve (every curve of ``params.CURVES``; ``csrc/curve_*.cu``). Replaces the
Pallas kernel ``msm_tpu/ops/pallas_curve.py::make_point_add``
(``pallas_call`` at :467).

``point_add`` takes six ``[B, L]`` int32 coordinate tensors (Montgomery
projective, balanced limbs) and returns three. On a CPU tensor it runs the
plain twin; on a CUDA tensor it launches the kernel (canonical outputs; a
thread per add, or a warp per add for batches within one wave,
``point_add_lanes``) or raises. Both results are congruent; compare after
``canonical``.
"""

from __future__ import annotations

import numpy as np
import torch

from msm_tpu_torch.ops import _build
from msm_tpu_torch.ops.field import FieldCtx, get_field_ctx
from msm_tpu_torch.params import MsmConfig
from msm_tpu_torch.utils.limbs import int_to_limbs


def b3_mont_limbs(cfg: MsmConfig) -> np.ndarray:
    """mont(3b): mont_mul(t, this) == 3b * t (reference CurveCtx.b3m_limbs)."""
    b3 = (3 * cfg.curve.b * cfg.r) % cfg.curve.modulus
    return int_to_limbs(b3, cfg.word_size, cfg.num_words).astype(np.int32)


def rcb16_add_plain(f: FieldCtx, b3m: torch.Tensor, x1, y1, z1, x2, y2, z2):
    """RCB16 Algorithm 7 (a = 0) on balanced limbs — the reference's
    ``CurveCtx._add_xla`` step for step."""
    t0 = f.mont_mul(x1, x2)
    t1 = f.mont_mul(y1, y2)
    t2 = f.mont_mul(z1, z2)
    t3 = f.mont_mul(f.add(x1, y1), f.add(x2, y2))
    t3 = f.sub(t3, f.add(t0, t1))
    t4 = f.mont_mul(f.add(y1, z1), f.add(y2, z2))
    t4 = f.sub(t4, f.add(t1, t2))
    t5 = f.mont_mul(f.add(x1, z1), f.add(x2, z2))
    t5 = f.sub(t5, f.add(t0, t2))
    t0_3 = f.add(f.double(t0), t0)
    t2b = f.mont_mul(t2, b3m)
    z3 = f.add(t1, t2b)
    t1m = f.sub(t1, t2b)
    y3 = f.mont_mul(t5, b3m)
    x3 = f.sub(f.mont_mul(t3, t1m), f.mont_mul(t4, y3))
    y3 = f.add(f.mont_mul(t1m, z3), f.mont_mul(y3, t0_3))
    z3 = f.add(f.mont_mul(z3, t4), f.mont_mul(t0_3, t3))
    return x3, y3, z3


def point_add_plain(cfg: MsmConfig, ax, ay, az, bx, by, bz):
    """Plain twin of the point-add kernel (any curve, any device)."""
    f = get_field_ctx(cfg)
    b3m = f.const(b3_mont_limbs(cfg), ax.device)
    return rcb16_add_plain(f, b3m, ax, ay, az, bx, by, bz)


def point_add_lanes(cfg: MsmConfig, B: int) -> bool:
    """The kernel gives each add a warp (its products split over the
    lanes: lower latency, 32 times the threads) when the batch's B warps
    fit in one wave of the word core's kernels on this curve
    (``_build.word_threads_per_sm``); else a thread per add."""
    return 32 * B <= _build.SMS * _build.word_threads_per_sm(cfg)


def point_add(cfg: MsmConfig, ax, ay, az, bx, by, bz):
    """P + Q over a batch: six ``[B, L]`` int32 tensors -> three."""
    if ax.device.type == "cpu":
        return point_add_plain(cfg, ax, ay, az, bx, by, bz)
    ins = _build.aligned(ax, ay, az, bx, by, bz)
    _build.require_cuda(cfg, *ins)
    B, L = ins[0].shape
    for t in ins:
        if t.shape != (B, L) or L != cfg.num_words:
            raise ValueError(f"expected [B, {cfg.num_words}] inputs, got {tuple(t.shape)}")
    out = [torch.empty_like(ins[0]) for _ in range(3)]
    lanes = point_add_lanes(cfg, B)
    _build.launch("msm_point_add", *ins, *out, B, int(lanes), _build.curve_id(cfg), width=cfg.word_size)
    point_add.launches += 1
    return tuple(out)


point_add.launches = 0
