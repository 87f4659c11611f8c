"""Batched elliptic-curve group ops on limb tensors — the PyTorch port of
``msm_tpu/ops/curve.py`` (``PointBatch``, ``point_where``, ``CurveCtx``,
``JacobianCtx``).

Complete projective formulas (Renes-Costello-Batina 2016) for a = 0 curves
on homogeneous (X : Y : Z) Montgomery coordinates, identity (0 : 1 : 0).

``CurveCtx.add`` is the one op with a kernel: it goes to
``cuda_curve.point_add``, which launches the CUDA kernel for CUDA tensors
and runs the plain twin for CPU tensors — the tensor's device decides,
nothing else. The ladders (``double_and_add``, ``scalar_mul_static``) are
built on it alone, each doubling an addition of a point to itself (the
formula is complete), so on CUDA each of their steps is one kernel launch
over the batch. The other ops are plain tensor code on any device.

``JacobianCtx`` is the reference's second implementation, kept for
differential tests: Jacobian coordinates (dbl-2009-l, add-2007-bl) with
the doubling, inverse and identity cases as selects, plain tensor code
with the reference's op order, so its limbs are the reference's bit for
bit.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from msm_tpu_torch.ops import cuda_curve
from msm_tpu_torch.ops.field import get_field_ctx
from msm_tpu_torch.params import MsmConfig


class PointBatch(NamedTuple):
    """Batch of projective points; each field is an int32 ``[..., L]``."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


def point_where(mask: torch.Tensor, a: PointBatch, b: PointBatch) -> PointBatch:
    """Elementwise select over the batch; ``mask`` is bool ``[...]``."""
    m = mask[..., None]
    return PointBatch(
        torch.where(m, a.x, b.x), torch.where(m, a.y, b.y), torch.where(m, a.z, b.z)
    )


class _PointCoords:
    """What the projective and the Jacobian coordinates share: the identity
    (0 : 1 : 0), an affine point with Z = 1, and Z = 0 as the identity
    test (``self.f`` the field)."""

    def identity(self, batch_shape=(), device="cuda") -> PointBatch:
        """(0 : 1 : 0) in Montgomery form."""
        f = self.f
        shape = tuple(batch_shape) + (f.L,)
        zero = f.const(f.zero_limbs, device).expand(shape).clone()
        one = f.const(f.r_limbs, device).expand(shape).clone()
        return PointBatch(zero, one, zero.clone())

    def from_affine_mont(self, x_m: torch.Tensor, y_m: torch.Tensor) -> PointBatch:
        one = self.f.const(self.f.r_limbs, x_m.device).expand(x_m.shape).clone()
        return PointBatch(x_m, y_m, one)

    def is_identity(self, p: PointBatch) -> torch.Tensor:
        return self.f.is_zero(p.z)


class CurveCtx(_PointCoords):
    """Complete-formula projective group ops for one MsmConfig (a = 0)."""

    def __init__(self, cfg: MsmConfig):
        if cfg.curve.a != 0:
            raise NotImplementedError("complete formulas implemented for a=0")
        self.cfg = cfg
        self.f = get_field_ctx(cfg)
        self.b3m_limbs = cuda_curve.b3_mont_limbs(cfg)

    def add(self, p: PointBatch, q: PointBatch) -> PointBatch:
        """Complete addition (RCB16 Algorithm 7) over broadcast batches:
        the CUDA point-add kernel for CUDA tensors, the plain twin for CPU
        tensors."""
        coords = torch.broadcast_tensors(*p, *q)
        batch = coords[0].shape[:-1]
        L = self.f.L
        flat = [c.reshape(-1, L) for c in coords]
        out = cuda_curve.point_add(self.cfg, *flat)
        return PointBatch(*(o.reshape(batch + (L,)) for o in out))

    def double(self, p: PointBatch) -> PointBatch:
        """Complete doubling (RCB16 Algorithm 9), plain tensor code."""
        f = self.f
        b3m = f.const(self.b3m_limbs, p.x.device)
        x, y, z = p
        t0 = f.mont_mul(y, y)
        z3 = f.double(f.double(f.double(t0)))
        t1 = f.mont_mul(y, z)
        t2 = f.mont_mul(f.mont_mul(z, z), b3m)
        x3 = f.mont_mul(t2, z3)
        y3 = f.add(t0, t2)
        z3 = f.mont_mul(t1, z3)
        t1 = f.double(t2)
        t2 = f.add(t1, t2)
        t0 = f.sub(t0, t2)
        y3 = f.add(x3, f.mont_mul(t0, y3))
        x3 = f.double(f.mont_mul(t0, f.mont_mul(x, y)))
        return PointBatch(x3, y3, z3)

    def neg(self, p: PointBatch) -> PointBatch:
        return PointBatch(p.x, self.f.neg(p.y), p.z)

    def neg_where(self, mask: torch.Tensor, p: PointBatch) -> PointBatch:
        return PointBatch(p.x, torch.where(mask[..., None], self.f.neg(p.y), p.y), p.z)

    def double_and_add(self, p: PointBatch, k: torch.Tensor, nbits: int) -> PointBatch:
        """p * k for per-element nonnegative scalars k (int32 ``[...]``) of
        at most ``nbits`` bits: branch-free, least significant bit first,
        the additions selected per element."""
        acc, base = self.identity(p.x.shape[:-1], p.x.device), p
        for i in range(nbits):
            bit = ((k >> i) & 1).to(torch.bool)
            acc = point_where(bit, self.add(acc, base), acc)
            base = self.add(base, base)
        return acc

    def scalar_mul_static(self, p: PointBatch, k: int) -> PointBatch:
        """p * k for one python-int scalar of any width, the same for the
        whole batch: most significant bit first, a doubling every bit and an
        addition of p where the bit is set. k is not reduced mod the order,
        so [r]P is the identity exactly for P in the order-r subgroup."""
        if k < 0:
            raise ValueError("negative static scalars are not supported")
        acc = self.identity(p.x.shape[:-1], p.x.device)
        for bit in bin(k)[2:] if k else "":
            acc = self.add(acc, acc)
            if bit == "1":
                acc = self.add(acc, p)
        return acc

    def to_affine_mont(self, p: PointBatch) -> tuple[torch.Tensor, torch.Tensor]:
        """(x / z, y / z) in Montgomery form, by Fermat inversion of z."""
        f = self.f
        zinv = f.mont_pow(p.z, self.cfg.curve.modulus - 2)
        return f.mont_mul(p.x, zinv), f.mont_mul(p.y, zinv)

    def eq(self, p: PointBatch, q: PointBatch) -> torch.Tensor:
        """Projective equality by cross-multiplication; identity == identity."""
        f = self.f
        pi, qi = self.is_identity(p), self.is_identity(q)
        xe = f.eq(f.mont_mul(p.x, q.z), f.mont_mul(q.x, p.z))
        ye = f.eq(f.mont_mul(p.y, q.z), f.mont_mul(q.y, p.z))
        return (pi & qi) | (~(pi ^ qi) & xe & ye)


class JacobianCtx(_PointCoords):
    """Jacobian group ops (dbl-2009-l, add-2007-bl) with the edge cases as
    selects, on Montgomery limbs (X/Z^2, Y/Z^3); identity (0 : 1 : 0)."""

    def __init__(self, cfg: MsmConfig):
        self.cfg = cfg
        self.f = get_field_ctx(cfg)

    def double(self, p: PointBatch) -> PointBatch:
        """dbl-2009-l; Z = 0 gives Z3 = 0."""
        f = self.f
        x1, y1, z1 = p
        a = f.mont_mul(x1, x1)
        b = f.mont_mul(y1, y1)
        c = f.mont_mul(b, b)
        t = f.add(x1, b)
        d = f.double(f.sub(f.mont_mul(t, t), f.add(a, c)))
        e = f.add(f.double(a), a)
        ff = f.mont_mul(e, e)
        x3 = f.sub(ff, f.double(d))
        c8 = f.double(f.double(f.double(c)))
        y3 = f.sub(f.mont_mul(e, f.sub(d, x3)), c8)
        z3 = f.double(f.mont_mul(y1, z1))
        return PointBatch(x3, y3, z3)

    def add(self, p: PointBatch, q: PointBatch) -> PointBatch:
        """add-2007-bl, then the selects in the reference's order: P + P
        (the doubling), P + (-P) (the identity), O + Q, P + O."""
        f = self.f
        x1, y1, z1 = p
        x2, y2, z2 = q
        z1z1 = f.mont_mul(z1, z1)
        z2z2 = f.mont_mul(z2, z2)
        u1 = f.mont_mul(x1, z2z2)
        u2 = f.mont_mul(x2, z1z1)
        s1 = f.mont_mul(f.mont_mul(y1, z2z2), z2)
        s2 = f.mont_mul(f.mont_mul(y2, z1z1), z1)
        h = f.sub(u2, u1)
        h2 = f.double(h)
        i = f.mont_mul(h2, h2)
        j = f.mont_mul(h, i)
        rr = f.double(f.sub(s2, s1))
        v = f.mont_mul(u1, i)
        x3 = f.sub(f.sub(f.mont_mul(rr, rr), j), f.double(v))
        y3 = f.sub(f.mont_mul(rr, f.sub(v, x3)), f.double(f.mont_mul(s1, j)))
        zs = f.add(z1, z2)
        z3 = f.mont_mul(f.sub(f.sub(f.mont_mul(zs, zs), z1z1), z2z2), h)
        out = PointBatch(x3, y3, z3)
        eq_u = f.eq(u1, u2)
        eq_s = f.eq(s1, s2)
        out = point_where(eq_u & eq_s, self.double(p), out)
        out = point_where(eq_u & ~eq_s, self.identity(x3.shape[:-1], x3.device), out)
        out = point_where(self.is_identity(p), q, out)
        return point_where(self.is_identity(q), p, out)

    def neg(self, p: PointBatch) -> PointBatch:
        return PointBatch(p.x, self.f.neg(p.y), p.z)

    def eq(self, p: PointBatch, q: PointBatch) -> torch.Tensor:
        """Jacobian equality by cross-multiplication by Z^2 and Z^3;
        identity == identity."""
        f = self.f
        z1z1 = f.mont_mul(p.z, p.z)
        z2z2 = f.mont_mul(q.z, q.z)
        xe = f.eq(f.mont_mul(p.x, z2z2), f.mont_mul(q.x, z1z1))
        ye = f.eq(f.mont_mul(p.y, f.mont_mul(z2z2, q.z)), f.mont_mul(q.y, f.mont_mul(z1z1, p.z)))
        pi, qi = self.is_identity(p), self.is_identity(q)
        return (pi & qi) | (~(pi ^ qi) & xe & ye)


@functools.lru_cache(maxsize=None)
def get_curve_ctx(cfg: MsmConfig) -> CurveCtx:
    return CurveCtx(cfg)


@functools.lru_cache(maxsize=None)
def get_jacobian_ctx(cfg: MsmConfig) -> JacobianCtx:
    return JacobianCtx(cfg)
