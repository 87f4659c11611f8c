"""Pure-Python (arbitrary-precision int) elliptic-curve oracle — the port's
own copy of ``msm_tpu/oracle/pyecc.py``.

Jacobian coordinates, identity (0, 1, 0): doubling dbl-2009-l, addition
add-2007-bl with the identity / doubling / inverse cases, y -> p - y for
the negation. Plain python ints mod p: slow, always exact. It is the exact
fallback of ``best_msm`` and the reference the device results are held to;
it is not a device path.
"""

from __future__ import annotations

from dataclasses import dataclass

from msm_tpu_torch.params import BN254, CurveSpec


@dataclass(frozen=True)
class JPoint:
    """Jacobian point (X, Y, Z): affine (X/Z^2, Y/Z^3); identity has Z=0."""

    x: int
    y: int
    z: int

    def is_identity(self) -> bool:
        return self.z == 0


IDENTITY = JPoint(0, 1, 0)


def sqrt_mod(a: int, p: int) -> int | None:
    """A square root of a mod the odd prime p (Tonelli-Shanks), or None
    where a is not a square."""
    a %= p
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    q, s = p - 1, 0
    while q % 2 == 0:
        q, s = q // 2, s + 1
    z = next(z for z in range(2, p) if pow(z, (p - 1) // 2, p) == p - 1)
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        i, t2 = 0, t
        while t2 != 1:
            t2, i = t2 * t2 % p, i + 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c, t, r = i, b * b % p, t * b * b % p, r * b % p
    return r


class Curve:
    """Group ops over a CurveSpec, plus MSM oracles."""

    def __init__(self, spec: CurveSpec = BN254):
        self.spec = spec
        self.p = spec.modulus
        self.order = spec.order
        self.g = JPoint(spec.gx % self.p, spec.gy % self.p, 1)

    # -- field helpers -------------------------------------------------------
    def _inv(self, a: int) -> int:
        return pow(a, -1, self.p)

    # -- point ops -----------------------------------------------------------
    def on_curve(self, pt: JPoint) -> bool:
        if pt.is_identity():
            return True
        x, y = self.to_affine(pt)
        return (y * y - (x * x * x + self.spec.a * x + self.spec.b)) % self.p == 0

    def to_affine(self, pt: JPoint) -> tuple[int, int]:
        if pt.is_identity():
            raise ValueError("identity has no affine form")
        zi = self._inv(pt.z)
        zi2 = zi * zi % self.p
        return pt.x * zi2 % self.p, pt.y * zi2 % self.p * zi % self.p

    def from_affine(self, x: int, y: int) -> JPoint:
        return JPoint(x % self.p, y % self.p, 1)

    def eq(self, a: JPoint, b: JPoint) -> bool:
        if a.is_identity() or b.is_identity():
            return a.is_identity() and b.is_identity()
        return self.to_affine(a) == self.to_affine(b)

    def neg(self, a: JPoint) -> JPoint:
        # y -> p - y (ec.template.wgsl:106-112)
        if a.is_identity():
            return a
        return JPoint(a.x, (self.p - a.y) % self.p, a.z)

    def double(self, a: JPoint) -> JPoint:
        """dbl-2009-l (a=0 curves) — the reference's point_double
        (ec.template.wgsl:10-34)."""
        p = self.p
        if a.is_identity():
            return a
        x1, y1, z1 = a.x, a.y, a.z
        aa = x1 * x1 % p
        b = y1 * y1 % p
        c = b * b % p
        d = 2 * ((x1 + b) * (x1 + b) % p - aa - c) % p
        e = 3 * aa % p
        f = e * e % p
        x3 = (f - 2 * d) % p
        y3 = (e * (d - x3) - 8 * c) % p
        z3 = 2 * y1 * z1 % p
        return JPoint(x3, y3, z3)

    def add(self, a: JPoint, b: JPoint) -> JPoint:
        """add-2007-bl with the identity / doubling / inverse special cases
        (the branches at ec.template.wgsl:36-86)."""
        p = self.p
        if a.is_identity():
            return b
        if b.is_identity():
            return a
        z1z1 = a.z * a.z % p
        z2z2 = b.z * b.z % p
        u1 = a.x * z2z2 % p
        u2 = b.x * z1z1 % p
        s1 = a.y * z2z2 % p * b.z % p
        s2 = b.y * z1z1 % p * a.z % p
        if u1 == u2:
            if s1 == s2:
                return self.double(a)
            return IDENTITY  # P + (-P)
        h = (u2 - u1) % p
        i = (2 * h) * (2 * h) % p
        j = h * i % p
        r = 2 * (s2 - s1) % p
        v = u1 * i % p
        x3 = (r * r - j - 2 * v) % p
        y3 = (r * (v - x3) - 2 * s1 * j) % p
        z3 = ((a.z + b.z) * (a.z + b.z) % p - z1z1 - z2z2) % p * h % p
        return JPoint(x3, y3, z3)

    def scalar_mul(self, a: JPoint, k: int) -> JPoint:
        """Double-and-add (full-width, MSB-first) — the reference's
        scalar_mul / double_and_add (ec.template.wgsl:88-102,124-139)."""
        k %= self.order
        acc = IDENTITY
        for bit in bin(k)[2:] if k else "":
            acc = self.double(acc)
            if bit == "1":
                acc = self.add(acc, a)
        return acc

    def in_subgroup(self, a: JPoint) -> bool:
        """[r]P == O with r not reduced (scalar_mul's k mod r would make it
        hold for every point): membership of the order-r subgroup."""
        acc = IDENTITY
        for bit in bin(self.order)[2:]:
            acc = self.double(acc)
            if bit == "1":
                acc = self.add(acc, a)
        return acc.is_identity()

    def lift_x(self, x: int) -> tuple[int, int] | None:
        """An affine point of the curve with this x (the smaller root y), or
        None where x^3 + a x + b is not a square mod p."""
        y = sqrt_mod((x * x * x + self.spec.a * x + self.spec.b) % self.p, self.p)
        return None if y is None else (x % self.p, min(y, self.p - y))

    def first_point_outside_subgroup(self, start: int = 2) -> tuple[int, int]:
        """The on-curve affine point of smallest x >= start that lies
        outside the order-r subgroup (on a curve of cofactor 1 there is
        none, and this raises)."""
        if self.spec.cofactor == 1:
            raise ValueError(f"{self.spec.name} has cofactor 1: every point is in the subgroup")
        x = start
        while True:
            pt = self.lift_x(x)
            if pt is not None and not self.in_subgroup(self.from_affine(*pt)):
                return pt
            x += 1

    # -- MSM oracles ---------------------------------------------------------
    def msm_naive(self, points: list[JPoint], scalars: list[int]) -> JPoint:
        """Direct sum of scalar muls — the slowest, most obviously-correct
        oracle (for differential-testing the Pippenger oracle)."""
        acc = IDENTITY
        for pt, k in zip(points, scalars):
            acc = self.add(acc, self.scalar_mul(pt, k))
        return acc

    def msm(self, points: list[JPoint], scalars: list[int], c: int | None = None) -> JPoint:
        """Serial Pippenger bucket MSM — the role halo2curves' ``msm_best``
        plays in the reference (``src/lib.rs:45-47``)."""
        n = len(points)
        assert n == len(scalars)
        if n == 0:
            return IDENTITY
        if c is None:
            c = 4 if n < 32 else max(4, n.bit_length() - 1)
            c = min(c, 16)
        nbits = 256
        nwin = -(-nbits // c)
        acc = IDENTITY
        for w in reversed(range(nwin)):
            for _ in range(c):
                acc = self.double(acc)
            buckets = [IDENTITY] * ((1 << c) - 1)
            shift = w * c
            m = (1 << c) - 1
            for pt, k in zip(points, scalars):
                digit = (k >> shift) & m
                if digit:
                    buckets[digit - 1] = self.add(buckets[digit - 1], pt)
            running = IDENTITY
            winsum = IDENTITY
            for b in reversed(buckets):
                running = self.add(running, b)
                winsum = self.add(winsum, running)
            acc = self.add(acc, winsum)
        return acc

    # -- sampling ------------------------------------------------------------
    def sample_points(self, n: int, seed: int = 0) -> list[JPoint]:
        """Random points as random-scalar multiples of the generator
        (the reference samples points the same way: ``src/lib.rs:30-42``)."""
        import random

        rng = random.Random(seed)
        return [
            self.scalar_mul(self.g, rng.randrange(1, self.order)) for _ in range(n)
        ]

    def sample_scalars(self, n: int, seed: int = 1) -> list[int]:
        import random

        rng = random.Random(seed)
        return [rng.randrange(self.order) for _ in range(n)]
