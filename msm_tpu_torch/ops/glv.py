"""GLV endomorphism decomposition — the port's own copy of
``msm_tpu/ops/glv.py`` (which imports JAX), with the device split written
for PyTorch tensors.

Curves with a = 0 carry the endomorphism phi(x, y) = (beta x, y) with
phi(P) = lambda P, beta and lambda primitive cube roots of unity in F_q and
F_r. A scalar k splits as k = k1 + k2 lambda (mod r) with |k1|, |k2| ~
sqrt(r), so

    sum k_i P_i  =  sum k1_i P_i + sum k2_i phi(P_i)

an MSM over 2n points with half-length scalars: the window count S halves
(BN254 at c = 16: 8 windows, not 16) while every subtask scans 2n entries.
Under ``MsmConfig.glv`` the point table carries rows (x R, beta x R, y R)
(``cuda_convert.convert_pack_glv``) and the scan kernels pick x or beta x
by bit 1 of an element's flags.

- ``glv_params``: (beta, lambda), the reduced lattice basis and the Babai
  multipliers, derived from the curve alone and matched on the generator
  with the port's oracle;
- ``split_scalar``: the host split, exact half-up rounding;
- ``split_scalars_device``: the same split on [n, 16] u16 scalar words as
  tensor operations (the products as two float64 GEMMs of 16-bit words,
  exact since every column sum stays below 2^53; int64 carries rippled
  over the columns), bit for bit the host split;
- ``decompose_signed_glv``: keys and signs [S, 2n] of the two halves.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from msm_tpu_torch.ops.decompose import extract_windows, signed_recode
from msm_tpu_torch.params import CurveSpec, MsmConfig

#: fixed-point precision of the Babai multipliers: truncating them moves a
#: candidate c_j by at most one (error < 2^(256 - M_BITS) per product)
M_BITS = 320


def _cube_root_of_unity(p: int) -> int:
    """A primitive cube root of unity mod p (p % 3 == 1)."""
    assert p % 3 == 1, p
    e = (p - 1) // 3
    for g in range(2, 100):
        c = pow(g, e, p)
        if c != 1:
            assert pow(c, 3, p) == 1
            return c
    raise AssertionError("no cube root found")


def _gauss_reduce(u, v, dot=lambda a, b: a[0] * b[0] + a[1] * b[1]):
    """Lagrange-Gauss reduction of a rank-2 integer lattice basis."""
    while True:
        if dot(u, u) > dot(v, v):
            u, v = v, u
        m = round(dot(u, v) / dot(u, u))
        if m == 0:
            return u, v
        v = (v[0] - m * u[0], v[1] - m * u[1])


@dataclass(frozen=True)
class GlvParams:
    beta: int  # cube root of unity in F_q: phi(x, y) = (beta x, y)
    lam: int  # the matching cube root of unity in F_r: phi(P) = lam P
    v1: tuple[int, int]  # short basis of {(a, b): a + b lam = 0 mod r}
    v2: tuple[int, int]
    g1: int  # floor(v2[1] 2^M / r)   (Babai rounding multipliers)
    g2: int  # floor(-v1[1] 2^M / r)
    max_component: int  # bound on |k1|, |k2| under exact rounding

    @property
    def half_bits(self) -> int:
        return self.max_component.bit_length()


@functools.lru_cache(maxsize=None)
def glv_params(curve: CurveSpec) -> GlvParams:
    """(beta, lambda, reduced basis, rounding multipliers) of an a = 0
    curve; the pairing of beta with lambda is checked on the generator."""
    from msm_tpu_torch.oracle.pyecc import Curve

    assert curve.a == 0, "the GLV cube-root endomorphism needs a = 0"
    r, q = curve.order, curve.modulus
    lam_c, beta_c = _cube_root_of_unity(r), _cube_root_of_unity(q)
    cv = Curve(curve)
    G = cv.from_affine(curve.gx, curve.gy)
    beta = lam = None
    for lc in (lam_c, pow(lam_c, 2, r)):
        want = cv.to_affine(cv.scalar_mul(G, lc))
        for bc in (beta_c, pow(beta_c, 2, q)):
            if ((curve.gx * bc) % q, curve.gy) == want:
                beta, lam = bc, lc
    assert beta is not None, "no (beta, lambda) pairing matched phi(G)"

    v1, v2 = _gauss_reduce((r, 0), (-lam % r, 1))
    # det = +r, so the Babai inverse is (v2[1], -v1[1]) / r
    det = v1[0] * v2[1] - v1[1] * v2[0]
    if det < 0:
        v2 = (-v2[0], -v2[1])
        det = -det
    assert det == r, det
    # both multipliers non-negative (flipping both vectors keeps det)
    if v2[1] < 0 and v1[1] > 0:
        v1 = (-v1[0], -v1[1])
        v2 = (-v2[0], -v2[1])
    assert v2[1] > 0 and v1[1] <= 0, (v1, v2)
    g1 = (v2[1] << M_BITS) // r
    g2 = ((-v1[1]) << M_BITS) // r
    # exact half-up rounding: |k_i| <= (|v1_i| + |v2_i|) / 2
    max_c = max((abs(v1[0]) + abs(v2[0]) + 1) // 2, (abs(v1[1]) + abs(v2[1]) + 1) // 2)
    return GlvParams(beta=beta, lam=lam, v1=v1, v2=v2, g1=g1, g2=g2, max_component=max_c)


def split_scalar(k: int, glv: GlvParams, r: int) -> tuple[int, int]:
    """Host Babai split: k = k1 + k2 lam (mod r) with exact half-up
    rounding, so |k_i| <= glv.max_component. The floored multipliers can
    leave a candidate c_j one below round-half-up(k b_j / r), never above;
    the exact remainder t = k b_j - c_j r corrects it (exact iff t lies in
    (-r/2, r/2])."""
    half = 1 << (M_BITS - 1)
    c1 = (k * glv.g1 + half) >> M_BITS
    c2 = (k * glv.g2 + half) >> M_BITS
    b1, b2 = glv.v2[1], -glv.v1[1]
    if 2 * (k * b1 - c1 * r) > r:
        c1 += 1
    if 2 * (k * b2 - c2 * r) > r:
        c2 += 1
    k1 = k - c1 * glv.v1[0] - c2 * glv.v2[0]
    k2 = -c1 * glv.v1[1] - c2 * glv.v2[1]
    assert (k1 + k2 * glv.lam - k) % r == 0
    assert abs(k1) <= glv.max_component and abs(k2) <= glv.max_component
    return k1, k2


# -- the device split: u16 words, products as exact float64 GEMMs -------------

#: words of c1, c2 (|c_j| < 2^130); of the remainder window (272 bits: the
#: guard 3r/2 exceeds 2^256 for a 256-bit order, and 2^272 - r/2 > 3r/2
#: keeps a negative t apart from the guard)
CW, RW = 9, 17


def _words(v: int, m: int) -> list[int]:
    """The m u16 words of v mod 2^(16 m), least significant first."""
    v %= 1 << (16 * m)
    return [(v >> (16 * i)) & 0xFFFF for i in range(m)]


def _toeplitz(b: int, k: int, m: int) -> np.ndarray:
    """T [k, m] with (a @ T)[:, c] = sum_i a_i b_(c - i): the column sums of
    u16 words a [., k] times the constant b mod 2^(16 m) (a negative b as
    its two's complement)."""
    bw = _words(b, m)
    t = np.zeros((k, m))
    for i in range(min(k, m)):
        t[i, i:] = bw[: m - i]
    return t


def _column_sums(a: torch.Tensor, t: np.ndarray) -> torch.Tensor:
    """u16 words a [k, n] (words first) times the product matrix t [k, q]
    -> column sums [q, n] int64. One float64 GEMM: a column sums at most 18
    products < 2^32, so every partial sum is an integer below 2^53 and the
    GEMM is exact in any order."""
    return (torch.from_numpy(t.T).to(a.device) @ a.to(torch.float64)).to(torch.int64)


def _ripple(cols: torch.Tensor, start: int = 0) -> torch.Tensor:
    """Column sums [B, m, n] (int64, >= 0) -> the u16 words [B, m - start, n]
    of each total mod 2^(16 m) from word ``start`` up: one carry step a
    column, over the whole batch."""
    carry = torch.zeros_like(cols[:, 0])
    out = []
    for c in range(cols.shape[1]):
        v = cols[:, c] + carry
        if c >= start:
            out.append(v & 0xFFFF)
        carry = v >> 16
    return torch.stack(out, dim=1)


def _gt_const(t: torch.Tensor, v: int) -> torch.Tensor:
    """t > v for u16 words t [B, m, n] and a constant v < 2^(16 m): the sign
    of the most significant word that differs."""
    m = t.shape[1]
    d = t - torch.tensor(_words(v, m), dtype=torch.int64, device=t.device)[:, None]
    idx = torch.arange(m, device=t.device)[:, None]
    top = torch.where(d != 0, idx, -1).amax(dim=1)  # [B, n]
    return (top >= 0) & (d.gather(1, top.clamp(min=0)[:, None])[:, 0] > 0)


def split_scalars_device(s_u16: torch.Tensor, cfg: MsmConfig):
    """The GLV split of [n, 16] u16 scalar words (held in int32) on their
    device: (|k1| [n, W], k1 < 0 [n], |k2| [n, W], k2 < 0 [n]) with
    W = ceil((half_bits + 1) / 16) u16 words (int32), bit for bit
    ``split_scalar``."""
    return _split_scalars_device(s_u16, cfg, glv_params(cfg.curve))


def _split_scalars_device(s_u16: torch.Tensor, cfg: MsmConfig, glv: GlvParams):
    """split_scalars_device with the GlvParams given: tests degrade g1, g2
    (g_j - 2^62 keeps every candidate within one of exact) so that the
    rounding correction fires on a measurable share of scalars, which the
    true multipliers do only in a window ~2^-66 wide.

    Words first ([word, n]) throughout. Two GEMMs carry every product: k
    times (g1, g2, b1, b2), then the candidates (c1, c2) times -r, -v1 and
    -v2; the carries ripple over the columns with the two halves (c1 and
    c2, t1 and t2, k1 and k2) side by side."""
    r = cfg.curve.order
    W = -(-(glv.half_bits + 1) // 16)
    TW = W + 1  # two's-complement width of k1, k2
    sw = M_BITS // 16
    k = s_u16.T & 0xFFFF  # [16, n]
    nk, n = k.shape
    (v10, v11), (v20, v21) = glv.v1, glv.v2
    # c_j = (k g_j + 2^(M-1)) >> M with the floored multipliers (one below
    # the rounded quotient at most), and k b_j for the remainders
    cols = _column_sums(k, np.hstack([_toeplitz(g, nk, sw + CW) for g in (glv.g1, glv.g2)]
                                     + [_toeplitz(b, nk, RW) for b in (v21, -v11)]))
    c = cols[: 2 * (sw + CW)].reshape(2, sw + CW, n)
    c[:, sw - 1] += 1 << 15
    c = _ripple(c, start=sw)  # [2, CW, n]
    # t_j = k b_j - c_j r (mod 2^(16 RW)); the parts of k1, k2 that c gives
    z = np.zeros((CW, RW))
    t2 = np.block([[_toeplitz(-r, CW, RW), z, _toeplitz(-v10, CW, TW), _toeplitz(-v11, CW, TW)],
                   [z, _toeplitz(-r, CW, RW), _toeplitz(-v20, CW, TW), _toeplitz(-v21, CW, TW)]])
    cc = _column_sums(c.reshape(2 * CW, n), t2)  # [2 RW + 2 TW, n]
    t = _ripple((cols[2 * (sw + CW) :] + cc[: 2 * RW]).reshape(2, RW, n))
    corr = (_gt_const(t, r // 2) & ~_gt_const(t, (3 * r) // 2)).to(torch.int64)  # c_j += 1
    # k1 = k - c1 v1[0] - c2 v2[0], k2 = -c1 v1[1] - c2 v2[1] (mod 2^(16 TW))
    kk = cc[2 * RW :].reshape(2, TW, n)
    kk[0, : min(TW, nk)] += k[:TW]
    for j, (va, vb) in enumerate(((v10, v11), (v20, v21))):
        fix = torch.tensor([_words(-va, TW), _words(-vb, TW)], dtype=torch.int64, device=k.device)
        kk += fix[..., None] * corr[j]
    kk = _ripple(kk)
    neg = (kk[:, TW - 1] >> 15) != 0  # [2, n]
    kk = torch.where(neg[:, None], kk ^ 0xFFFF, kk)
    kk[:, 0] += neg
    a = _ripple(kk)[:, :W].to(torch.int32)  # [2, W, n]
    return a[0].T, neg[0], a[1].T, neg[1]


def decompose_halves(split, chunk_size: int, num_subtasks: int):
    """The split's two halves -> (keys [S, 2n], signs [S, 2n] bool): columns
    n..2n-1 belong to the phi(P) copies, and each half's digit signs are
    XORed with that half's sign (-k = sum of -d_j 2^(c j))."""
    a1, n1, a2, n2 = split
    keys, signs = [], []
    for a, neg in ((a1, n1), (a2, n2)):
        d = signed_recode(extract_windows(a, chunk_size, num_subtasks), chunk_size)
        keys.append(d.abs())
        signs.append((d < 0) ^ neg[None, :])
    return torch.cat(keys, dim=1), torch.cat(signs, dim=1)


def decompose_signed_glv(s_u16: torch.Tensor, chunk_size: int, num_subtasks: int, cfg: MsmConfig):
    """The GLV stage-1 scalar path: [n, 16] u16 scalar words -> keys and
    signs [S, 2n] (``decompose_halves`` of ``split_scalars_device``)."""
    return decompose_halves(split_scalars_device(s_u16, cfg), chunk_size, num_subtasks)
