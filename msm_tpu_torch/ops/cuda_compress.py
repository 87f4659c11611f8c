"""Kernels 10-13: batched-affine pair compression of the sorted stream, with
their plain twins and the two host functions built on them.

CUDA source: ``msm_tpu_torch/csrc/compress.cu``, all four kernels on the
word core (the pair algebra and the bodies of kernels 10, 11 and 12 in
``csrc/pair32.cuh``, kernel 13's in ``csrc/emit_scan.cuh``, all generic
over the field). Kernels 12 and 13 (``pair_suffix``, ``emit_scan``: the
MSM's compressed scan), kernels 10 and 11 (``pair_forward``,
``pair_backward``: ``compress_pairs``) and their GLV modes run every curve
of ``params.CURVES`` (``csrc/pairs.cuh``, the C entries taking the curve's
index).
Replaces, in ``msm_tpu/ops/pallas_compress.py``: ``make_pair_suffix``
(``pallas_call`` at :427), ``make_emit_scan`` (:561), ``make_pair_forward``
(:205) and ``make_pair_backward`` (:333), with the sorted-order gather that
fed them (``msm_tpu/ops/scan.py:349``): the kernels gather their own rows.

Pair j of lane r adds the sorted elements at steps (2j, 2j+1) of the
step-major layout. Every function takes the packed point table [N, 2D] and,
per subtask g, ``perm[g, c, r]`` (table row of step c of lane r) and
``flags[g, c, r]`` (bit 0: negate y), with C = 2 Cp steps. Under GLV the
table is [N, 3D] (rows x, beta x, y) and bit 1 of the flags takes beta x:
each kernel then runs its GLV mode (``pair_forward_glv``,
``pair_backward_glv``, ``pair_suffix_glv``, ``emit_scan_glv``: own C
entries, own launch counters, replacing ``_load_pair_point``'s GLV branch,
``pallas_compress.py:122-140``). The twins take both layouts.

    d   = x2 - x1 | 2 y1' (doubling) | R, Montgomery one (P + (-P))
    num = y2' - y1' | 3 x1^2 (doubling)
    lam = num / d,  x3 = lam^2 - x1 - x2,  y3 = lam (x1 - x3) - y1'

- ``pair_suffix``: s [G, Cp, L, R], s_j = d_j ... d_{Cp-1}
- ``emit_scan(s, t0)``: t0 = inv(s_0); inv(d_j) = t_j s_{j+1}, t_{j+1} =
  t_j d_j; the pair sums go straight into a mixed-add prefix scan (an
  infinity pair leaves it unchanged), with ``scan_rows``'s outputs: pe3
  [G, Cp, R, 3L] and lane totals t{x,y,z} [G, L, R]
- ``pair_forward``: m [G, Cp, L, R], m_j = d_0 ... d_j
- ``pair_backward(m, minv)``: minv = inv(m_last); the pair sums cx, cy
  [G, Cp, L, R] and infinity flags inf [G, Cp, R]

``compressed_prefix_scan`` (the MSM's path) is suffix, one ``mont_pow`` per
lane, emit+scan; ``compress_pairs`` (the surface an oracle can check pair
by pair) is forward, ``mont_pow``, backward, with or without GLV.

Chain values the kernels write are canonical, and the kernels read s and m
as canonical, so on CUDA feed them the kernels' own outputs; t0 and minv may
be balanced. The twins take and give the field layer's balanced limbs.
"""

from __future__ import annotations

import torch

from msm_tpu_torch.ops import _build, bigint
from msm_tpu_torch.ops.cuda_convert import coord_words, table_coords, unpack_coords
from msm_tpu_torch.ops.cuda_curve import b3_mont_limbs
from msm_tpu_torch.ops.cuda_inv import mont_pow
from msm_tpu_torch.ops.cuda_scan import element_coords, pe3_row_limbs, rcb16_madd_plain
from msm_tpu_torch.ops.field import FieldCtx, get_field_ctx
from msm_tpu_torch.params import MsmConfig

# -- pair algebra (twins of csrc/pair32.cuh) -----------------------------------


def pair_predicates_plain(cfg: MsmConfig, x1, y1, s1, x2, y2, s2):
    """(dbl, inf) bool for canonical coordinates [..., L] and sign bits [...]:

        e1 ==  e2 <=> x1 == x2 and (s1 == s2 ? y1 == y2 : y1 + y2 == p)
        e1 == -e2 <=> x1 == x2 and (s1 != s2 ? y1 == y2 : y1 + y2 == p)"""
    f = get_field_ctx(cfg)
    same_x = (x1 == x2).all(-1)
    same_y = (y1 == y2).all(-1)
    limbs, carry = bigint.carry_propagate(y1 + y2, cfg.word_size)
    ysum_p = (limbs == f.const(f.p_limbs, y1.device)).all(-1) & (carry == 0)
    same_s = s1 == s2
    dbl = same_x & torch.where(same_s, same_y, ysum_p)
    inf = same_x & torch.where(same_s, ysum_p, same_y)
    return dbl, inf


def signed_y_plain(f: FieldCtx, y, s):
    """y' = s ? p - y : y (balanced)."""
    return torch.where(s[..., None] != 0, f.const(f.p_limbs, y.device) - y, y)


def pair_denominator_plain(f: FieldCtx, x1, y1p, x2, dbl, inf):
    d = torch.where(dbl[..., None], f.add(y1p, y1p), f.sub(x2, x1))
    return torch.where(inf[..., None], f.const(f.r_limbs, d.device), d)


def pair_numerator_plain(f: FieldCtx, x1, y1p, y2p, dbl):
    x1sq = f.mont_mul(x1, x1)
    return torch.where(dbl[..., None], f.add(f.add(x1sq, x1sq), x1sq), f.sub(y2p, y1p))


def pair_emit_plain(f: FieldCtx, num, inv_d, x1, x2, y1p):
    """The affine pair sum (x3, y3) from num and inv_d = 1/d."""
    lam = f.mont_mul(num, inv_d)
    x3 = f.sub(f.sub(f.mont_mul(lam, lam), x1), x2)
    y3 = f.sub(f.mont_mul(lam, f.sub(x1, x3)), y1p)
    return x3, y3


def _pairs_plain(cfg: MsmConfig, packed, perm, flags):
    """Gather every pair of every lane at once: (x1, y1', x2, y2', d, num,
    dbl, inf), coordinates [G, Cp, R, L], predicates [G, Cp, R]."""
    f = get_field_ctx(cfg)
    rows = packed[perm.to(torch.int64)]  # [G, C, R, 2D or 3D]
    x, y = (unpack_coords(a, cfg) for a in element_coords(cfg, rows, flags))
    s = flags & 1
    x1, y1, s1, x2, y2, s2 = x[:, 0::2], y[:, 0::2], s[:, 0::2], x[:, 1::2], y[:, 1::2], s[:, 1::2]
    dbl, inf = pair_predicates_plain(cfg, x1, y1, s1, x2, y2, s2)
    y1p, y2p = signed_y_plain(f, y1, s1), signed_y_plain(f, y2, s2)
    d = pair_denominator_plain(f, x1, y1p, x2, dbl, inf)
    num = pair_numerator_plain(f, x1, y1p, y2p, dbl)
    return x1, y1p, x2, y2p, d, num, dbl, inf


def _chain_plain(f: FieldCtx, d, start, reverse: bool):
    """Running products along the pairs of every lane: d [G, Cp, R, L],
    start [G, R, L]. Returns (after, before) [G, Cp, R, L]: the running value
    after and before multiplying in d_j, in walking order."""
    Cp = d.shape[1]
    run = start
    after, before = [None] * Cp, [None] * Cp
    for j in reversed(range(Cp)) if reverse else range(Cp):
        before[j] = run
        run = f.mont_mul(run, d[:, j])
        after[j] = run
    return torch.stack(after, dim=1), torch.stack(before, dim=1)


def _one(f: FieldCtx, like: torch.Tensor) -> torch.Tensor:
    return f.const(f.r_limbs, like.device).expand(like.shape).clone()


def _limbs_first(a: torch.Tensor) -> torch.Tensor:
    return a.transpose(-1, -2).contiguous()


def _check(cfg: MsmConfig, packed, perm, flags, *chain):
    """Checks before a pair kernel's launch: the gather inputs' shapes, and
    every tensor (chain inputs included) CUDA int32; contiguous copies."""
    ts = [t.contiguous() for t in (packed, perm, flags, *chain)]
    _build.require_cuda(cfg, *ts)
    packed, perm, flags = ts[:3]
    if (perm.dim() != 3 or flags.shape != perm.shape or perm.shape[1] % 2
            or packed.shape[1:] != (table_coords(cfg) * coord_words(cfg),)):
        raise ValueError(f"bad pair shapes {tuple(packed.shape)} {tuple(perm.shape)}")
    return ts


def _check_chain(chain, chain_shape, lane, lane_shape) -> None:
    if tuple(chain.shape) != chain_shape or tuple(lane.shape) != lane_shape:
        raise ValueError(f"expected {chain_shape} and {lane_shape}, "
                         f"got {tuple(chain.shape)} and {tuple(lane.shape)}")


# -- kernels 12, 13: the MSM's compressed scan --------------------------------


def pair_suffix_plain(cfg: MsmConfig, packed, perm, flags):
    """Plain twin: suffix products of the pair denominators, walking the
    pairs backwards with all G x R lanes as one batch."""
    f = get_field_ctx(cfg)
    d = _pairs_plain(cfg, packed, perm, flags)[4]
    s, _ = _chain_plain(f, d, _one(f, d[:, 0]), reverse=True)
    return _limbs_first(s)


def emit_scan_plain(cfg: MsmConfig, packed, perm, flags, s, t0):
    """Plain twin: the forward inverse chain and every pair sum first, then
    the mixed-add scan over the pairs."""
    f = get_field_ctx(cfg)
    x1, y1p, x2, _, d, num, _, inf = _pairs_plain(cfg, packed, perm, flags)
    _, t = _chain_plain(f, d, t0.transpose(-1, -2), reverse=False)
    s_rl = s.transpose(-1, -2)  # [G, Cp, R, L]
    s_next = torch.cat([s_rl[:, 1:], _one(f, s_rl[:, :1])], dim=1)
    x3, y3 = pair_emit_plain(f, num, f.mont_mul(t, s_next), x1, x2, y1p)

    G, Cp, R, L = x1.shape
    dev = packed.device
    b3m = f.const(b3_mont_limbs(cfg), dev)
    acc = (torch.zeros((G, R, L), dtype=torch.int32, device=dev),
           _one(f, x1[:, 0]), torch.zeros((G, R, L), dtype=torch.int32, device=dev))
    pe3 = torch.empty((G, Cp, R, 3 * L), dtype=torch.int32, device=dev)
    for j in range(Cp):
        new = rcb16_madd_plain(f, b3m, *acc, x3[:, j], y3[:, j])
        keep = inf[:, j, :, None]
        acc = tuple(torch.where(keep, a, b) for a, b in zip(acc, new))
        pe3[:, j] = torch.cat(acc, dim=-1)
    return (pe3, *(_limbs_first(a) for a in acc))


def _suffix(cfg: MsmConfig, packed, perm, flags, entry: str, counter):
    packed, perm, flags = _check(cfg, packed, perm, flags)
    (packed,) = _build.aligned(packed)  # 16-byte row loads
    G, C, R = perm.shape
    s = torch.empty((G, C // 2, cfg.num_words, R), dtype=torch.int32, device=packed.device)
    _build.launch(entry, packed, perm, flags, s, G, C // 2, R, _build.curve_id(cfg), width=cfg.word_size)
    counter.launches += 1
    return s


def pair_suffix(cfg: MsmConfig, packed, perm, flags):
    """(packed [N, 2D], perm [G, 2Cp, R], flags) -> s [G, Cp, L, R]; under
    GLV ``pair_suffix_glv``."""
    if cfg.glv:
        return pair_suffix_glv(cfg, packed, perm, flags)
    if packed.device.type == "cpu":
        return pair_suffix_plain(cfg, packed, perm, flags)
    return _suffix(cfg, packed, perm, flags, "msm_pair_suffix", pair_suffix)


def pair_suffix_glv(cfg: MsmConfig, packed, perm, flags):
    """The GLV mode: packed [N, 3D], flags bit 1 choosing beta x."""
    if not cfg.glv:
        raise ValueError("pair_suffix_glv needs a GLV config")
    if packed.device.type == "cpu":
        return pair_suffix_plain(cfg, packed, perm, flags)
    return _suffix(cfg, packed, perm, flags, "msm_pair_suffix_glv", pair_suffix_glv)


pair_suffix.launches = 0
pair_suffix_glv.launches = 0


def _emit(cfg: MsmConfig, packed, perm, flags, s, t0, entry: str, counter):
    packed, perm, flags, s, t0 = _check(cfg, packed, perm, flags, s, t0)
    (packed,) = _build.aligned(packed)  # 16-byte row loads
    G, C, R = perm.shape
    L = cfg.num_words
    _check_chain(s, (G, C // 2, L, R), t0, (G, L, R))
    dev = packed.device
    # rows padded to a multiple of 4 limbs, as the scan writes them
    pe3 = torch.empty((G, C // 2, R, pe3_row_limbs(cfg)), dtype=torch.int32, device=dev)
    tots = [torch.empty((G, L, R), dtype=torch.int32, device=dev) for _ in range(3)]
    _build.launch(entry, packed, perm, flags, s, t0, pe3, *tots, G, C // 2, R, _build.curve_id(cfg),
                  width=cfg.word_size)
    counter.launches += 1
    return (pe3[..., :3 * L], *tots)


def emit_scan(cfg: MsmConfig, packed, perm, flags, s, t0):
    """(packed, perm, flags, s [G, Cp, L, R], t0 [G, L, R]) ->
    (pe3 [G, Cp, R, 3L], tx, ty, tz [G, L, R]); under GLV
    ``emit_scan_glv``."""
    if cfg.glv:
        return emit_scan_glv(cfg, packed, perm, flags, s, t0)
    if packed.device.type == "cpu":
        return emit_scan_plain(cfg, packed, perm, flags, s, t0)
    return _emit(cfg, packed, perm, flags, s, t0, "msm_emit_scan", emit_scan)


def emit_scan_glv(cfg: MsmConfig, packed, perm, flags, s, t0):
    """The GLV mode: packed [N, 3D], flags bit 1 choosing beta x."""
    if not cfg.glv:
        raise ValueError("emit_scan_glv needs a GLV config")
    if packed.device.type == "cpu":
        return emit_scan_plain(cfg, packed, perm, flags, s, t0)
    return _emit(cfg, packed, perm, flags, s, t0, "msm_emit_scan_glv", emit_scan_glv)


emit_scan.launches = 0
emit_scan_glv.launches = 0


def compressed_prefix_scan(cfg: MsmConfig, packed, perm, flags):
    """The prefix scan over the pair-compressed stream: suffix products,
    one Fermat inversion per lane, fused emission + scan. Same outputs as
    ``scan_rows`` over Cp = C/2 compressed steps."""
    s = pair_suffix(cfg, packed, perm, flags)
    t0 = mont_pow(cfg, s[:, 0], cfg.curve.modulus - 2)
    return emit_scan(cfg, packed, perm, flags, s, t0)


# -- kernels 10, 11: the pair values ------------------------------------------


def pair_forward_plain(cfg: MsmConfig, packed, perm, flags):
    """Plain twin: running products of the pair denominators."""
    f = get_field_ctx(cfg)
    d = _pairs_plain(cfg, packed, perm, flags)[4]
    m, _ = _chain_plain(f, d, _one(f, d[:, 0]), reverse=False)
    return _limbs_first(m)


def pair_backward_plain(cfg: MsmConfig, packed, perm, flags, m, minv):
    """Plain twin: the backward inverse chain, then every pair sum."""
    f = get_field_ctx(cfg)
    x1, y1p, x2, _, d, num, _, inf = _pairs_plain(cfg, packed, perm, flags)
    _, run = _chain_plain(f, d, minv.transpose(-1, -2), reverse=True)
    m_rl = m.transpose(-1, -2)
    m_prev = torch.cat([_one(f, m_rl[:, :1]), m_rl[:, :-1]], dim=1)
    x3, y3 = pair_emit_plain(f, num, f.mont_mul(m_prev, run), x1, x2, y1p)
    return _limbs_first(x3), _limbs_first(y3), inf.to(torch.int32)


def _forward(cfg: MsmConfig, packed, perm, flags, entry: str, counter):
    packed, perm, flags = _check(cfg, packed, perm, flags)
    (packed,) = _build.aligned(packed)  # 16-byte row loads
    G, C, R = perm.shape
    m = torch.empty((G, C // 2, cfg.num_words, R), dtype=torch.int32, device=packed.device)
    _build.launch(entry, packed, perm, flags, m, G, C // 2, R, _build.curve_id(cfg), width=cfg.word_size)
    counter.launches += 1
    return m


def pair_forward(cfg: MsmConfig, packed, perm, flags):
    """(packed [N, 2D], perm [G, 2Cp, R], flags) -> m [G, Cp, L, R]; under
    GLV ``pair_forward_glv``."""
    if cfg.glv:
        return pair_forward_glv(cfg, packed, perm, flags)
    if packed.device.type == "cpu":
        return pair_forward_plain(cfg, packed, perm, flags)
    return _forward(cfg, packed, perm, flags, "msm_pair_forward", pair_forward)


def pair_forward_glv(cfg: MsmConfig, packed, perm, flags):
    """The GLV mode: packed [N, 3D], flags bit 1 choosing beta x."""
    if not cfg.glv:
        raise ValueError("pair_forward_glv needs a GLV config")
    if packed.device.type == "cpu":
        return pair_forward_plain(cfg, packed, perm, flags)
    return _forward(cfg, packed, perm, flags, "msm_pair_forward_glv", pair_forward_glv)


pair_forward.launches = 0
pair_forward_glv.launches = 0


def _backward(cfg: MsmConfig, packed, perm, flags, m, minv, entry: str, counter):
    packed, perm, flags, m, minv = _check(cfg, packed, perm, flags, m, minv)
    (packed,) = _build.aligned(packed)  # 16-byte row loads
    G, C, R = perm.shape
    L = cfg.num_words
    _check_chain(m, (G, C // 2, L, R), minv, (G, L, R))
    dev = packed.device
    cx, cy = (torch.empty((G, C // 2, L, R), dtype=torch.int32, device=dev) for _ in range(2))
    inf = torch.empty((G, C // 2, R), dtype=torch.int32, device=dev)
    _build.launch(entry, packed, perm, flags, m, minv, cx, cy, inf, G, C // 2, R,
                  _build.curve_id(cfg), width=cfg.word_size)
    counter.launches += 1
    return cx, cy, inf


def pair_backward(cfg: MsmConfig, packed, perm, flags, m, minv):
    """(packed, perm, flags, m [G, Cp, L, R], minv [G, L, R]) ->
    (cx, cy [G, Cp, L, R], inf [G, Cp, R] int32); under GLV
    ``pair_backward_glv``."""
    if cfg.glv:
        return pair_backward_glv(cfg, packed, perm, flags, m, minv)
    if packed.device.type == "cpu":
        return pair_backward_plain(cfg, packed, perm, flags, m, minv)
    return _backward(cfg, packed, perm, flags, m, minv, "msm_pair_backward", pair_backward)


def pair_backward_glv(cfg: MsmConfig, packed, perm, flags, m, minv):
    """The GLV mode: packed [N, 3D], flags bit 1 choosing beta x."""
    if not cfg.glv:
        raise ValueError("pair_backward_glv needs a GLV config")
    if packed.device.type == "cpu":
        return pair_backward_plain(cfg, packed, perm, flags, m, minv)
    return _backward(cfg, packed, perm, flags, m, minv, "msm_pair_backward_glv", pair_backward_glv)


pair_backward.launches = 0
pair_backward_glv.launches = 0


def compress_pairs(cfg: MsmConfig, packed, perm, flags):
    """Every pair sum of every lane: forward products, one Fermat inversion
    per lane, backward emission -> (cx, cy [G, Cp, L, R] Montgomery affine,
    inf [G, Cp, R]; an infinity pair's coordinates mean nothing). Under GLV
    (packed [N, 3D]) the GLV modes of the forward and backward kernels."""
    m = pair_forward(cfg, packed, perm, flags)
    minv = mont_pow(cfg, m[:, -1], cfg.curve.modulus - 2)
    return pair_backward(cfg, packed, perm, flags, m, minv)
