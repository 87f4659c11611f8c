"""Kernel 4: the per-lane prefix scan of mixed additions over the sorted
points (the hot kernel), and its plain twin.

CUDA source: ``msm_tpu_torch/csrc/scan.cu`` (per-lane body
``csrc/scan.cuh``, on the 32-bit-word core ``csrc/fe32.cuh``; both modes
for every curve of ``params.CURVES``). Replaces the
Pallas kernel ``msm_tpu/ops/pallas_scan.py::make_scan_rows``
(``pallas_call`` at :374) together with the sorted-order gather
``packed[perm2]`` that fed it (``msm_tpu/ops/scan.py:545``): the kernel
gathers its own rows. Both modes: ``scan_rows`` the plain one,
``scan_rows_glv`` the GLV one (:260-291), each with its own C entry and
launch counter.

Inputs: the packed point table [N, 2D] (GLV: [N, 3D], rows x, beta x, y),
and per subtask g the step-major permutation ``perm[g, c, r]`` (table row
of the c-th point of lane r) with its flags (bit 0: negate y; GLV bit 1:
take beta x). Outputs: ``pe3[g, c, r]`` = the inclusive prefix of lane r
after step c as one x||y||z row [3L], and the lane totals
``t{x,y,z}[g, :, r]`` limbs-first [G, L, R]. On CUDA pe3 is the [..., :3L]
view of rows padded to ``pe3_row_limbs`` (a multiple of 4 limbs).
"""

from __future__ import annotations

import torch

from msm_tpu_torch.ops import _build
from msm_tpu_torch.ops.cuda_convert import coord_words, table_coords, unpack_coords
from msm_tpu_torch.ops.cuda_curve import b3_mont_limbs
from msm_tpu_torch.ops.field import FieldCtx, get_field_ctx
from msm_tpu_torch.params import MsmConfig


def rcb16_madd_plain(f: FieldCtx, b3m: torch.Tensor, x1, y1, z1, x2, y2):
    """RCB16 Algorithm 8 (a = 0): projective (x1, y1, z1) + affine (x2, y2),
    the reference's ``pallas_scan._rcb16_madd`` formula sequence."""
    t0 = f.mont_mul(x1, x2)
    t1 = f.mont_mul(y1, y2)
    t3 = f.mont_mul(f.add(x2, y2), f.add(x1, y1))
    t3 = f.sub(t3, f.add(t0, t1))
    t4 = f.add(f.mont_mul(y2, z1), y1)
    y3 = f.add(f.mont_mul(x2, z1), x1)
    t0_3 = f.add(f.double(t0), t0)
    t2 = f.mont_mul(z1, b3m)
    z3 = f.add(t1, t2)
    t1 = f.sub(t1, t2)
    y3 = f.mont_mul(y3, b3m)
    x3 = f.sub(f.mont_mul(t3, t1), f.mont_mul(t4, y3))
    y3 = f.add(f.mont_mul(y3, t0_3), f.mont_mul(t1, z3))
    z3 = f.add(f.mont_mul(z3, t4), f.mont_mul(t0_3, t3))
    return x3, y3, z3


def element_coords(cfg: MsmConfig, rows: torch.Tensor, flags: torch.Tensor):
    """Dense x and y words [..., D] of the elements whose table rows are
    rows [..., 2D] (GLV: [..., 3D], x taken from the beta x half where bit 1
    of flags [...] is set)."""
    D = coord_words(cfg)
    x = rows[..., :D]
    if cfg.glv:
        x = torch.where((((flags >> 1) & 1) != 0)[..., None], rows[..., D : 2 * D], x)
    return x, rows[..., -D:]


def scan_rows_plain(cfg: MsmConfig, packed, perm, flags):
    """Plain twin, both modes: gather, then a serial loop over the C steps
    with all G x R lanes as one batch."""
    f = get_field_ctx(cfg)
    L = cfg.num_words
    G, C, R = perm.shape
    dev = packed.device
    b3m = f.const(b3_mont_limbs(cfg), dev)
    p = f.const(f.p_limbs, dev)
    g = packed[perm.to(torch.int64)]  # [G, C, R, 2D or 3D]
    neg = (flags & 1) != 0
    ax = torch.zeros((G, R, L), dtype=torch.int32, device=dev)
    ay = f.const(f.r_limbs, dev).expand(G, R, L).clone()
    az = torch.zeros((G, R, L), dtype=torch.int32, device=dev)
    pe3 = torch.empty((G, C, R, 3 * L), dtype=torch.int32, device=dev)
    for c in range(C):
        x2, y2 = (unpack_coords(a, cfg) for a in element_coords(cfg, g[:, c], flags[:, c]))
        y2 = torch.where(neg[:, c, :, None], p - y2, y2)
        ax, ay, az = rcb16_madd_plain(f, b3m, ax, ay, az, x2, y2)
        pe3[:, c] = torch.cat([ax, ay, az], dim=-1)
    return (pe3, *(t.transpose(1, 2).contiguous() for t in (ax, ay, az)))


def pe3_row_limbs(cfg: MsmConfig) -> int:
    """int32 limbs of one pe3 row as the kernel writes it: x || y || z (3L)
    padded to a multiple of 4, so every row takes 16-byte stores (BN254:
    60; 21 limbs: 64; 30 limbs: 92). The wrappers return the [..., :3L]
    view."""
    return -(-3 * cfg.num_words // 4) * 4


def _scan(cfg: MsmConfig, packed, perm, flags, entry: str, counter):
    packed, perm, flags = packed.contiguous(), perm.contiguous(), flags.contiguous()
    if packed.data_ptr() % 16:  # the kernel reads rows with 16-byte loads
        packed = packed.clone()
    _build.require_cuda(cfg, packed, perm, flags)
    L, D = cfg.num_words, coord_words(cfg)
    G, C, R = perm.shape
    if flags.shape != perm.shape or packed.shape[1:] != (table_coords(cfg) * D,):
        raise ValueError(f"bad scan shapes {tuple(packed.shape)} {tuple(perm.shape)}")
    dev = packed.device
    pe3 = torch.empty((G, C, R, pe3_row_limbs(cfg)), dtype=torch.int32, device=dev)
    tots = [torch.empty((G, L, R), dtype=torch.int32, device=dev) for _ in range(3)]
    _build.launch(entry, packed, perm, flags, pe3, *tots, G, C, R, _build.curve_id(cfg), width=cfg.word_size)
    counter.launches += 1
    return (pe3[..., :3 * L], *tots)


def scan_rows(cfg: MsmConfig, packed, perm, flags):
    """(packed [N, 2D], perm [G, C, R], flags [G, C, R]) ->
    (pe3 [G, C, R, 3L], tx, ty, tz [G, L, R]); under GLV ``scan_rows_glv``."""
    if cfg.glv:
        return scan_rows_glv(cfg, packed, perm, flags)
    if packed.device.type == "cpu":
        return scan_rows_plain(cfg, packed, perm, flags)
    return _scan(cfg, packed, perm, flags, "msm_scan", scan_rows)


def scan_rows_glv(cfg: MsmConfig, packed, perm, flags):
    """The GLV mode: packed [N, 3D], flags bit 1 choosing beta x."""
    if not cfg.glv:
        raise ValueError("scan_rows_glv needs a GLV config")
    if packed.device.type == "cpu":
        return scan_rows_plain(cfg, packed, perm, flags)
    return _scan(cfg, packed, perm, flags, "msm_scan_rows_glv", scan_rows_glv)


scan_rows.launches = 0
scan_rows_glv.launches = 0
