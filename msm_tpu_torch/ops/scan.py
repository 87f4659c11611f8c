"""Sort/scan bucket machinery — the PyTorch port of ``msm_tpu/ops/scan.py``:
the bucket-boundary prefixes, the telescoped window sum of the cuZK main
path, and the bucket-reduction family (``bucket_accumulate``,
``bucket_reduce_running``, ``bucket_reduce_blocked``).

Per subtask (window) the signed digits become bucket keys; one unstable
``torch.sort`` orders all windows' keys at once, carrying point index and
sign in an int32 payload. Each lane of the scan kernel then owns a
contiguous run of sorted positions, and the bucket-boundary prefixes are
read out of the per-lane prefixes plus the lane offsets:

    pe[b] = offsets[r] + pe3[c, r],  i = ends[b] - 1, r = i // C, c = i % C

Under ``cfg.compress`` the scan runs over the pair-compressed stream
(``cuda_compress.compressed_prefix_scan``: adjacent sorted elements summed
in affine form first, C/2 steps per lane), and a boundary that falls inside
a pair gets its own element added back (``prefix_at_compressed``).

Under ``cfg.glv`` a subtask's stream holds 2n entries over the n-row table
of rows (x, beta x, y): entry i >= n is the phi copy of point i - n. The
payload decode turns that into the physical row and bit 1 of the flags
(``_decode_payload_step_major(table_rows=n)``), which the kernels' GLV
modes and ``prefix_at_compressed`` read.

The main path's window sum follows from the boundary prefixes by
telescoping (``window_sum_from_pe``). The naive model takes the per-bucket
sums instead (``bucket_accumulate``: pe[b] - pe[b-1]) and reduces them by
the serial running sum; the reference-shaped cuZK stage 4 reduces them
two-phase, lane-parallel (``bucket_reduce_blocked``: kernel 8, then a tail
on the point-add, point-total and Horner kernels). Every point addition and
doubling on these paths goes through a kernel wrapper (``cuda_*``), so on
CUDA tensors they run on the kernels.

The plain helpers at the top (``hillis_steele_prefix``,
``exclusive_prefix_points``, ``tree_reduce_points``) are building blocks of
the kernels' plain twins: they always use the plain addition, on any device,
along the point axis ``dim=-2`` with any leading batch axes.
"""

from __future__ import annotations

import torch

from msm_tpu_torch.ops.cuda_bpr import bpr_phase1
from msm_tpu_torch.ops.cuda_compress import compressed_prefix_scan
from msm_tpu_torch.ops.cuda_convert import unpack_coords
from msm_tpu_torch.ops.cuda_curve import point_add_plain
from msm_tpu_torch.ops.cuda_hist import bucket_hist
from msm_tpu_torch.ops.cuda_prefix import horner, point_total, row_offsets
from msm_tpu_torch.ops.cuda_scan import element_coords, scan_rows
from msm_tpu_torch.ops.curve import CurveCtx, PointBatch, get_curve_ctx, point_where
from msm_tpu_torch.params import MsmConfig

# -- plain helpers (twins) ---------------------------------------------------


def _add_plain(cfg: MsmConfig, p: PointBatch, q: PointBatch) -> PointBatch:
    return PointBatch(*point_add_plain(cfg, *p, *q))


def _cat(parts: list[PointBatch], dim: int) -> PointBatch:
    return PointBatch(*(torch.cat(c, dim=dim) for c in zip(*parts)))


def _shift_in_identity(ec: CurveCtx, pts: PointBatch, k: int = 1) -> PointBatch:
    """out[..., i] = pts[..., i - k] along dim -2, identity at i < k."""
    ident = ec.identity(pts.x.shape[:-2] + (k,), pts.x.device)
    return _cat([ident, PointBatch(*(a[..., :-k, :] for a in pts))], dim=-2)


def _flip(pts: PointBatch) -> PointBatch:
    return PointBatch(*(a.flip(-2) for a in pts))


def hillis_steele_prefix(cfg: MsmConfig, pts: PointBatch) -> PointBatch:
    """Inclusive prefix sums along dim -2 in log2(m) rounds of batched adds."""
    m = pts.x.shape[-2]
    ident = get_curve_ctx(cfg).identity(pts.x.shape[:-1], pts.x.device)
    k = 1
    while k < m:
        shifted = PointBatch(
            *(torch.cat([i[..., :k, :], a[..., :-k, :]], dim=-2) for i, a in zip(ident, pts))
        )
        pts = _add_plain(cfg, pts, shifted)
        k *= 2
    return pts


def exclusive_prefix_points(cfg: MsmConfig, pts: PointBatch) -> PointBatch:
    """out[i] = sum_{j < i} pts[j] along dim -2 (out[0] = identity)."""
    return _shift_in_identity(get_curve_ctx(cfg), hillis_steele_prefix(cfg, pts))


def tree_reduce_points(cfg: MsmConfig, pts: PointBatch) -> PointBatch:
    """Sum along dim -2 by halving (m - 1 adds in log2(m) batched rounds)."""
    ec = get_curve_ctx(cfg)
    while pts.x.shape[-2] > 1:
        m = pts.x.shape[-2]
        if m % 2:
            pad = ec.identity(pts.x.shape[:-2] + (1,), pts.x.device)
            pts = _cat([pts, pad], dim=-2)
            m += 1
        h = m // 2
        pts = _add_plain(
            cfg,
            PointBatch(*(a[..., :h, :] for a in pts)),
            PointBatch(*(a[..., h:, :] for a in pts)),
        )
    if pts.x.shape[-2] == 0:
        return ec.identity(pts.x.shape[:-2], pts.x.device)
    return PointBatch(*(a[..., 0, :] for a in pts))


# -- main path ------------------------------------------------------------------


def sort_payload(
    keys: torch.Tensor, signs: torch.Tensor | None
) -> tuple[torch.Tensor, int]:
    """Sort every row of keys [G, n] (unstable: bucket sums do not depend on
    the order within a key) and return the sorted payload [G, n] int32:
    point index in bits [0, sbit), the sign in bit sbit. ``signs=None``:
    unsigned keys, no sign bit (the kernels then read all-zero flags)."""
    n = keys.shape[-1]
    sbit = max((n - 1).bit_length(), 1)
    assert sbit + 1 < 32, n
    payload = torch.arange(n, dtype=torch.int32, device=keys.device).expand(keys.shape)
    if signs is not None:
        payload = payload | (signs.to(torch.int32) << sbit)
    perm = torch.sort(keys, dim=-1).indices
    return payload.gather(-1, perm), sbit


def _decode_payload_step_major(
    pv: torch.Tensor, sbit: int, R: int, table_rows: int | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sorted payload [G, n] -> step-major (perm, flags) [G, C, R]: element
    (c, r) is sorted position r*C + c; perm is the table row, flags bit 0
    the sign. ``table_rows`` (GLV): the stream indexes 2 table_rows entries
    over a table of table_rows rows; entry i's phi bit (i >= table_rows)
    goes to bit 1 of its flags and perm is the row i mod table_rows."""
    G, n = pv.shape
    pv2 = pv.reshape(G, R, n // R).transpose(1, 2)
    idx, flags = pv2 & ((1 << sbit) - 1), pv2 >> sbit
    if table_rows is not None:
        assert table_rows & (table_rows - 1) == 0, table_rows
        flags = flags | ((idx // table_rows) << 1)
        idx = idx % table_rows
    return idx.contiguous(), flags.contiguous()


def _counts_leq(cfg: MsmConfig, keys: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """ends[g, b] = #{i : keys[g, i] <= b}: histogram kernel + cumsum."""
    return torch.cumsum(bucket_hist(cfg, keys, num_buckets), dim=-1, dtype=torch.int32)


def compression_applies(cfg: MsmConfig, n: int, num_rows: int) -> bool:
    """Pair compression runs when the config asks for it and every lane
    holds an even number of steps C = n / R, so that no pair (2j, 2j+1)
    straddles two lanes. n and R are powers of two, so every size
    compresses except C = 1 (R = n); under ``pick_geometry(n, c,
    compress=True)`` (R = min(n/8, ``geometry.COMPRESS_ROWS``), so C >= 8)
    every padded size does.
    The JAX package also asks R % 256 == 0, a TPU tile rule not carried
    over: the boundary prefixes are the same points either way."""
    return cfg.compress and (n // num_rows) % 2 == 0


def prefix_at(
    ec: CurveCtx, pe3: torch.Tensor, offsets: PointBatch, idx: torch.Tensor
) -> PointBatch:
    """Inclusive prefixes at sorted positions idx [G, m] (-1 -> identity):
    one gathered pe3 row plus the lane offset, by the point-add kernel."""
    G, C = pe3.shape[:2]
    valid = idx >= 0
    i = idx.clamp(min=0).to(torch.int64)
    r, c = i // C, i % C
    gi = torch.arange(G, device=pe3.device)[:, None]
    out = ec.add(_offset_at(offsets, gi, r), _pe3_row(ec, pe3, gi, c, r))
    return point_where(valid, out, ec.identity(idx.shape, pe3.device))


def prefix_at_compressed(
    ec: CurveCtx,
    pe3: torch.Tensor,
    offsets: PointBatch,
    packed: torch.Tensor,
    perm: torch.Tensor,
    flags: torch.Tensor,
    idx: torch.Tensor,
) -> PointBatch:
    """``prefix_at`` over the pair-compressed scan (pe3 [G, Cp, R, 3L], pair
    j of lane r = steps 2j, 2j+1). A boundary at step c of lane r takes the
    last whole pair at or before it, and the element at step c itself when c
    is even (the boundary falls inside a pair):

        pe = offsets[r] + pe3[(c - 1) // 2, r] + (c even ? element (c, r) : 0)

    The element is its packed row (under GLV with x or beta x by bit 1 of
    its flags) with y negated by bit 0 and z = one. Both additions go
    through the point-add kernel."""
    cfg = ec.cfg
    G, Cp = pe3.shape[:2]
    valid = idx >= 0
    i = idx.clamp(min=0).to(torch.int64)
    r, c = i // (2 * Cp), i % (2 * Cp)
    j = torch.div(c - 1, 2, rounding_mode="floor")  # -1: no whole pair yet
    gi = torch.arange(G, device=pe3.device)[:, None]
    ident = ec.identity(idx.shape, pe3.device)
    pairs = point_where(j >= 0, _pe3_row(ec, pe3, gi, j.clamp(min=0), r), ident)
    base = ec.add(_offset_at(offsets, gi, r), pairs)
    row = packed[perm[gi, c, r].to(torch.int64)]  # [G, m, 2D or 3D]
    fl = flags[gi, c, r]
    x, y = (unpack_coords(a, cfg) for a in element_coords(cfg, row, fl))
    y = torch.where(((fl & 1) != 0)[..., None], ec.f.const(ec.f.p_limbs, y.device) - y, y)
    elem = ec.from_affine_mont(x, y)
    out = ec.add(base, point_where(c % 2 == 0, elem, ident))
    return point_where(valid, out, ident)


def _pe3_row(ec: CurveCtx, pe3: torch.Tensor, gi, c, r) -> PointBatch:
    row = pe3[gi, c, r]  # [G, m, 3L]
    L = ec.f.L
    return PointBatch(row[..., :L], row[..., L : 2 * L], row[..., 2 * L :])


def _offset_at(offsets: PointBatch, gi, r) -> PointBatch:
    return PointBatch(*(a[gi, r] for a in offsets))


def _batch_boundary_prefix(
    ec: CurveCtx,
    packed: torch.Tensor,
    pv: torch.Tensor,
    sbit: int,
    num_rows: int,
    ends: torch.Tensor,
) -> PointBatch:
    """Boundary prefixes of one batch of subtasks: the prefix scan (plain, or
    over the pair-compressed stream), the row-offsets kernel, the readout.
    The batch's pe3 and offsets die when this returns, so only one batch is
    alive at a time."""
    cfg = ec.cfg
    table_rows = packed.shape[0] if cfg.glv else None
    perm, flags = _decode_payload_step_major(pv, sbit, num_rows, table_rows)
    compress = compression_applies(cfg, pv.shape[-1], num_rows)
    scan = compressed_prefix_scan if compress else scan_rows
    pe3, tx, ty, tz = scan(cfg, packed, perm, flags)
    offsets = PointBatch(*row_offsets(cfg, tx, ty, tz))
    if compress:
        return prefix_at_compressed(ec, pe3, offsets, packed, perm, flags, ends - 1)
    return prefix_at(ec, pe3, offsets, ends - 1)


def bucket_boundary_prefix(
    ec: CurveCtx,
    packed: torch.Tensor,
    keys: torch.Tensor,
    signs: torch.Tensor | None,
    num_buckets: int,
    num_rows: int,
    batch: int,
) -> PointBatch:
    """pe[g, b] = the signed point sum over all elements of subtask g with
    key <= b, so bucket_b = pe[b] - pe[b-1]. keys/signs [G, n] (signs None:
    every point added); the sort and the bucket ends cover all G rows at
    once, the scans run ``batch`` subtasks at a time (pair-compressed where
    ``compression_applies``). Returns [G, num_buckets, L] coordinates."""
    pv, sbit = sort_payload(keys, signs)
    ends = _counts_leq(ec.cfg, keys, num_buckets)
    outs = [
        _batch_boundary_prefix(
            ec, packed, pv[g0 : g0 + batch], sbit, num_rows, ends[g0 : g0 + batch]
        )
        for g0 in range(0, keys.shape[0], batch)
    ]
    return _cat(outs, dim=0)


def _fold(ec: CurveCtx, lo: PointBatch, hi: PointBatch, log2_m: int) -> PointBatch:
    """lo + 2^log2_m * hi over a batch [G, L], as one Horner-kernel launch
    over the G two-point ladders (hi, lo): log2_m doublings (RCB16
    Algorithm 9) and one addition."""
    w = [torch.stack([a, b], dim=-2) for a, b in zip(lo, hi)]  # [G, 2, L]
    return PointBatch(*horner(ec.cfg, *w, log2_m))


def window_sum_from_pe(ec: CurveCtx, pe: PointBatch) -> PointBatch:
    """W = sum_b b*S_b straight from the boundary prefixes [S, B, L]:

        sum_b b*(pe_b - pe_{b-1}) = (B-1)*pe_{B-1} - sum_{b<B-1} pe_b

    one point-total kernel, then W = -total + 2^(c-1) pe_{B-1} (B-1 =
    2^(c-1)) as one Horner-kernel launch over the S windows."""
    B = pe.x.shape[-2]
    assert (B - 1) & (B - 2) == 0, f"B-1 = {B - 1} must be a power of two"
    total = PointBatch(*point_total(ec.cfg, *(a[..., :-1, :] for a in pe)))
    last = PointBatch(*(a[..., -1, :] for a in pe))
    return _fold(ec, ec.neg(total), last, (B - 1).bit_length() - 1)


# -- bucket sums and their reductions ------------------------------------------


def bucket_accumulate(
    ec: CurveCtx,
    packed: torch.Tensor,
    keys: torch.Tensor,
    signs: torch.Tensor | None,
    num_buckets: int,
    num_rows: int,
    batch: int,
) -> PointBatch:
    """Per-bucket signed point sums S[g, b] = sum over keys[g] == b of
    +-P_i, [G, num_buckets, L]: the boundary prefixes differenced,
    pe[b] - pe[b-1] (identity before bucket 0), in one point-add launch
    over all G * num_buckets buckets."""
    pe = bucket_boundary_prefix(ec, packed, keys, signs, num_buckets, num_rows, batch)
    return ec.add(pe, ec.neg(_shift_in_identity(ec, pe)))


def bucket_reduce_running(ec: CurveCtx, buckets: PointBatch) -> PointBatch:
    """W = sum_b b * S_b over buckets [..., B, L] by the descending running
    sum (bucket 0 skipped): 2(B-1) point-add launches, each over the whole
    batch [...]."""
    B = buckets.x.shape[-2]
    running = acc = ec.identity(buckets.x.shape[:-2], buckets.x.device)
    for b in range(B - 1, 0, -1):
        running = ec.add(running, PointBatch(*(a[..., b, :] for a in buckets)))
        acc = ec.add(acc, running)
    return acc


def _suffix_sums(ec: CurveCtx, pts: PointBatch) -> PointBatch:
    """out[..., j] = sum_{t >= j} pts[..., t] along dim -2: log2(m) rounds
    of point-add launches over the flipped points."""
    pts = _flip(pts)
    k = 1
    while k < pts.x.shape[-2]:
        pts = ec.add(pts, _shift_in_identity(ec, pts, k))
        k *= 2
    return _flip(pts)


def bucket_reduce_blocked(ec: CurveCtx, buckets: PointBatch, num_threads: int) -> PointBatch:
    """W = sum_b b * S_b over buckets [..., B, L] by the two-phase blocked
    reduction (cuZK Algorithm 4), lane-parallel over T = num_threads lanes
    per subtask. Lane t owns the Bl = (B-1)/T buckets 1 + t*Bl .. (t+1)*Bl.

    Phase 1 (kernel 8): every lane's block sum m_t and sum of running sums
    g_t. Phase 2: W = sum_t g_t + Bl * sum_t t*m_t, where sum_t t*m_t =
    sum_j suffix_j - suffix_0 with suffix_j = sum_{t>=j} m_t: a reverse
    ladder of point-add launches, two point-total launches, and W =
    total_g + 2^log2(Bl) * corr as one Horner-kernel launch. Bl must be a
    power of two."""
    B, L = buckets.x.shape[-2:]
    batch = buckets.x.shape[:-2]
    T = num_threads
    assert (B - 1) % T == 0, (B - 1, T)
    Bl = (B - 1) // T
    assert Bl & (Bl - 1) == 0, f"block size {Bl} must be a power of two"
    cfg = ec.cfg

    def arrange(a):  # body [..., B-1, L] -> [G, Bl, T, L], step-major
        return a[..., 1:, :].reshape(-1, T, Bl, L).transpose(1, 2).contiguous()

    out = bpr_phase1(cfg, *(arrange(a) for a in buckets))
    m, g = PointBatch(*out[:3]), PointBatch(*out[3:])
    total_g = PointBatch(*point_total(cfg, *g))
    suff = _suffix_sums(ec, m)
    suff_total = PointBatch(*point_total(cfg, *suff))
    corr = ec.add(suff_total, ec.neg(PointBatch(*(a[:, 0] for a in suff))))
    w = _fold(ec, total_g, corr, Bl.bit_length() - 1)
    return PointBatch(*(a.reshape(batch + (L,)) for a in w))
