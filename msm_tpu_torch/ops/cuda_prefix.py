"""Kernels 5-7: row offsets, point total and the Horner ladder, with their
plain twins.

CUDA sources: ``msm_tpu_torch/csrc/prefix.cu`` (row offsets),
``csrc/point_total.cu`` (point total) and ``csrc/horner.cu`` (Horner
ladder), all three on the 32-bit-word core (``csrc/fe32.cuh``), generic
over the curve (every curve of ``params.CURVES``).
Replaces, in ``msm_tpu/ops/pallas_prefix.py``: ``make_row_offsets``
(``pallas_call`` at :133), ``make_point_total`` (:231) and
``make_horner_ladder`` (:335).

Layouts: row offsets take the scan's lane totals limbs-first [G, L, R] and
return the exclusive prefixes [G, R, L]; point total reduces [G, N, L] to
one point per subtask [G, L] (the TPU's 128 replicated lanes are dropped);
Horner folds window sums [S, L] into one point [L], or G ladders at once,
[G, S, L] -> [G, L].

Row offsets run as three kernels per launch (a reduce-then-scan over the
whole card, ``row_offsets_plan``), point total as two (partial sums over
the card, ``point_total_plan``, then one warp per subtask).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from msm_tpu_torch.ops import _build
from msm_tpu_torch.params import MsmConfig, coord_words

THREADS = 128  # block size of the row-offsets and point-total kernels (csrc BLOCK)
#: threads an SM holds at the row-offsets kernels' ~255 registers per
#: thread (no minimum of blocks per SM in their __launch_bounds__)
RESIDENT_THREADS = 256
LANES_PER_THREAD = (1, 2, 4, 8)


def pt_words(cfg: MsmConfig) -> int:
    """int32 words of one partial sum of the point-total kernel: x, y, z of
    D words each (csrc/point_total.cuh pt_words<F>; BN254: 24)."""
    return 3 * coord_words(cfg)


@dataclass(frozen=True)
class RowOffsetsPlan:
    """Launch plan of the row offsets over R lanes: thread j of block b owns
    lanes (b * threads + j) * lanes_per_thread + c, c < lanes_per_thread;
    ``blocks`` blocks per subtask, and ``scan_threads`` threads scan their
    block totals."""

    lanes_per_thread: int
    blocks: int
    scan_threads: int
    threads: int = THREADS


def row_offsets_plan(groups: int, R: int) -> RowOffsetsPlan:
    """The fewest lanes per thread (at most 8 and at most R) that keep the
    G * R / k threads within one wave of RESIDENT_THREADS per SM, and as
    many blocks as cover R."""
    for k in LANES_PER_THREAD:
        if k >= R or groups * R // k <= _build.SMS * RESIDENT_THREADS:
            break
    blocks = -(-R // (k * THREADS))
    return RowOffsetsPlan(k, blocks, min(THREADS, 1 << (blocks - 1).bit_length()))


def row_offsets_plain(cfg: MsmConfig, tx, ty, tz):
    """Plain twin: exclusive prefix along the lanes, batched over G."""
    from msm_tpu_torch.ops.curve import PointBatch
    from msm_tpu_torch.ops.scan import exclusive_prefix_points

    pts = PointBatch(*(t.transpose(-1, -2) for t in (tx, ty, tz)))
    return tuple(exclusive_prefix_points(cfg, pts))


def row_offsets(cfg: MsmConfig, tx, ty, tz):
    """Exclusive point prefix over lane totals: [G, L, R] x3 -> [G, R, L] x3."""
    if tx.device.type == "cpu":
        return row_offsets_plain(cfg, tx, ty, tz)
    ins = _build.aligned(tx, ty, tz)
    _build.require_cuda(cfg, *ins)
    G, L, R = ins[0].shape
    if L != cfg.num_words or R & (R - 1):
        raise ValueError(f"expected [G, {cfg.num_words}, 2^k], got {tuple(ins[0].shape)}")
    plan = row_offsets_plan(G, R)
    dev = tx.device
    out = [torch.empty((G, R, L), dtype=torch.int32, device=dev) for _ in range(3)]
    scratch = [torch.empty((G, plan.blocks, L), dtype=torch.int32, device=dev) for _ in range(3)]
    _build.launch("msm_row_offsets", *ins, *out, *scratch, G, R, plan.lanes_per_thread,
                  plan.blocks, plan.scan_threads, _build.curve_id(cfg), width=cfg.word_size)
    row_offsets.launches += 1
    return tuple(out)


row_offsets.launches = 0


def point_total_plain(cfg: MsmConfig, px, py, pz):
    """Plain twin: halving tree reduction, batched over G."""
    from msm_tpu_torch.ops.curve import PointBatch
    from msm_tpu_torch.ops.scan import tree_reduce_points

    return tuple(tree_reduce_points(cfg, PointBatch(px, py, pz)))


@dataclass(frozen=True)
class PointTotalPlan:
    """Launch plan of the point total over N points per subtask: thread j
    of block b (of ``blocks`` per subtask) sums points j' k .. j' k + k - 1,
    j' = b * threads + j, k = ``points_per_thread``."""

    points_per_thread: int
    blocks: int
    threads: int = THREADS


def point_total_plan(cfg: MsmConfig, groups: int, N: int) -> PointTotalPlan:
    """The fewest points per thread that keep the G * N / k threads within
    one wave of the word core's kernels on this curve
    (``_build.word_threads_per_sm``), and as many blocks as cover N (one
    when N = 0)."""
    k = max(1, -(-groups * N // (_build.SMS * _build.word_threads_per_sm(cfg))))
    return PointTotalPlan(k, max(1, -(-N // (k * THREADS))))


def point_total(cfg: MsmConfig, px, py, pz):
    """Sum of N points per subtask: [G, N, L] x3 -> [G, L] x3."""
    if px.device.type == "cpu":
        return point_total_plain(cfg, px, py, pz)
    ins = _build.aligned(px, py, pz)
    _build.require_cuda(cfg, *ins)
    G, N, L = ins[0].shape
    if L != cfg.num_words:
        raise ValueError(f"expected [G, N, {cfg.num_words}], got {tuple(ins[0].shape)}")
    plan = point_total_plan(cfg, G, N)
    dev = px.device
    part = torch.empty((G, plan.blocks, pt_words(cfg)), dtype=torch.int32, device=dev)
    out = [torch.empty((G, L), dtype=torch.int32, device=dev) for _ in range(3)]
    _build.launch("msm_point_total", *ins, part, *out, G, N, plan.points_per_thread, plan.blocks,
                  _build.curve_id(cfg), width=cfg.word_size)
    point_total.launches += 1
    return tuple(out)


point_total.launches = 0


def horner_plain(cfg: MsmConfig, wx, wy, wz, chunk: int):
    """Plain twin: Horner's rule over the S window sums [..., S, L], one
    point per leading index."""
    from msm_tpu_torch.ops.cuda_curve import point_add_plain
    from msm_tpu_torch.ops.curve import PointBatch, get_curve_ctx

    ec = get_curve_ctx(cfg)
    S = wx.shape[-2]
    acc = PointBatch(wx[..., S - 1, :], wy[..., S - 1, :], wz[..., S - 1, :])
    for s in range(S - 2, -1, -1):
        for _ in range(chunk):
            acc = ec.double(acc)
        acc = PointBatch(*point_add_plain(cfg, *acc, wx[..., s, :], wy[..., s, :], wz[..., s, :]))
    return tuple(acc)


def horner(cfg: MsmConfig, wx, wy, wz, chunk: int):
    """sum_s 2^(chunk*s) W_s: [S, L] x3 -> [L] x3, or G ladders at once,
    [G, S, L] x3 -> [G, L] x3. On CUDA one warp per ladder splits each
    formula's products over its lanes."""
    if wx.device.type == "cpu":
        return horner_plain(cfg, wx, wy, wz, chunk)
    ins = [t.contiguous() for t in (wx, wy, wz)]
    _build.require_cuda(cfg, *ins)
    shape = ins[0].shape
    if len(shape) not in (2, 3) or shape[-1] != cfg.num_words or shape[-2] < 1:
        raise ValueError(f"expected [G, S, {cfg.num_words}] or [S, {cfg.num_words}], got {tuple(shape)}")
    G = shape[0] if len(shape) == 3 else 1
    out = [torch.empty(shape[:-2] + shape[-1:], dtype=torch.int32, device=wx.device) for _ in range(3)]
    _build.launch("msm_horner", *ins, *out, G, shape[-2], chunk, _build.curve_id(cfg), width=cfg.word_size)
    horner.launches += 1
    return tuple(out)


horner.launches = 0
