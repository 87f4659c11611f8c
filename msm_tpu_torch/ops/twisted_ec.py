"""Twisted-Edwards group ops in extended coordinates — the port of
``msm_tpu/ops/twisted_ec.py``.

Curves a*x^2 + y^2 = 1 + d*x^2*y^2; points (X : Y : T : Z) with T = XY/Z,
each coordinate an int32 ``[..., L]`` tensor of Montgomery limbs on the
port's ``FieldCtx``. Addition (add-2008-hwcd) and doubling (dbl-2008-hwcd)
are complete for a square a and a non-square d. Plain tensor code on any
device, with the reference's op order, so its limbs are the reference's
bit for bit. No MSM path uses it.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from msm_tpu_torch.ops.field import get_field_ctx
from msm_tpu_torch.params import CurveSpec, MsmConfig
from msm_tpu_torch.utils.limbs import int_to_limbs


@dataclass(frozen=True)
class TwistedEdwardsSpec:
    """a*x^2 + y^2 = 1 + d*x^2*y^2 over GF(modulus)."""

    name: str
    modulus: int
    a: int
    d: int


#: Baby Jubjub, the twisted-Edwards curve over BN254's scalar field
#: (EIP-2494 parameters)
BABY_JUBJUB = TwistedEdwardsSpec(
    name="baby_jubjub",
    modulus=21888242871839275222246405745257275088548364400416034343698204186575808495617,
    a=168700,
    d=168696,
)


class ExtPoint(NamedTuple):
    """Extended coordinates (X : Y : T : Z), T = X*Y/Z; each ``[..., L]``."""

    x: torch.Tensor
    y: torch.Tensor
    t: torch.Tensor
    z: torch.Tensor


class TwistedEdwardsCtx:
    """Batched extended-coordinate group ops for one twisted-Edwards curve."""

    def __init__(self, spec: TwistedEdwardsSpec, word_size: int = 13):
        self.spec = spec
        # the field layer needs only the modulus: a CurveSpec that carries it
        self.cfg = MsmConfig(
            curve=CurveSpec(name=f"_field_{spec.name}", modulus=spec.modulus, order=spec.modulus,
                            a=0, b=0, gx=0, gy=0),
            word_size=word_size,
        )
        self.f = get_field_ctx(self.cfg)
        self.a_m = self._mont(spec.a)
        self.d_m = self._mont(spec.d)

    def _mont(self, v: int) -> np.ndarray:
        """Montgomery limbs of v mod the modulus."""
        p = self.spec.modulus
        return int_to_limbs(v % p * self.cfg.r % p, self.cfg.word_size, self.cfg.num_words).astype(np.int32)

    def identity(self, batch_shape=(), device="cuda") -> ExtPoint:
        """(0 : 1 : 0 : 1) in Montgomery form."""
        f = self.f
        shape = tuple(batch_shape) + (f.L,)
        zero = f.const(f.zero_limbs, device).expand(shape)
        one = f.const(f.r_limbs, device).expand(shape)
        return ExtPoint(zero.clone(), one.clone(), zero.clone(), one.clone())

    def from_affine(self, x: int, y: int, batch_shape=(), device="cuda") -> ExtPoint:
        """Affine ints -> the extended Montgomery point, broadcast to
        ``batch_shape``."""
        shape = tuple(batch_shape) + (self.f.L,)

        def lift(v: int) -> torch.Tensor:
            return torch.from_numpy(self._mont(v)).to(device).expand(shape).clone()

        return ExtPoint(lift(x), lift(y), lift(x * y), lift(1))

    def add(self, p: ExtPoint, q: ExtPoint) -> ExtPoint:
        """add-2008-hwcd."""
        f = self.f
        dev = p.x.device
        A = f.mont_mul(p.x, q.x)
        B = f.mont_mul(p.y, q.y)
        C = f.mont_mul(f.mont_mul(p.t, q.t), f.const(self.d_m, dev))
        D = f.mont_mul(p.z, q.z)
        E = f.mont_mul(f.add(p.x, p.y), f.add(q.x, q.y))
        E = f.sub(E, f.add(A, B))
        F = f.sub(D, C)
        G = f.add(D, C)
        H = f.sub(B, f.mont_mul(A, f.const(self.a_m, dev)))
        return ExtPoint(f.mont_mul(E, F), f.mont_mul(G, H), f.mont_mul(E, H), f.mont_mul(F, G))

    def double(self, p: ExtPoint) -> ExtPoint:
        """dbl-2008-hwcd."""
        f = self.f
        A = f.mont_mul(p.x, p.x)
        B = f.mont_mul(p.y, p.y)
        C = f.double(f.mont_mul(p.z, p.z))
        D = f.mont_mul(A, f.const(self.a_m, p.x.device))
        E = f.mont_mul(f.add(p.x, p.y), f.add(p.x, p.y))
        E = f.sub(E, f.add(A, B))
        G = f.add(D, B)
        F = f.sub(G, C)
        H = f.sub(D, B)
        return ExtPoint(f.mont_mul(E, F), f.mont_mul(G, H), f.mont_mul(E, H), f.mont_mul(F, G))

    def neg(self, p: ExtPoint) -> ExtPoint:
        f = self.f
        return ExtPoint(f.neg(p.x), p.y, f.neg(p.t), p.z)

    def eq(self, p: ExtPoint, q: ExtPoint) -> torch.Tensor:
        """Projective equality: X1 Z2 == X2 Z1 and Y1 Z2 == Y2 Z1."""
        f = self.f
        xe = f.eq(f.mont_mul(p.x, q.z), f.mont_mul(q.x, p.z))
        ye = f.eq(f.mont_mul(p.y, q.z), f.mont_mul(q.y, p.z))
        return xe & ye


@functools.lru_cache(maxsize=None)
def get_twisted_ctx(spec: TwistedEdwardsSpec = BABY_JUBJUB) -> TwistedEdwardsCtx:
    return TwistedEdwardsCtx(spec)
