"""The plain reference: short-Weierstrass arithmetic in Python integers and
the MSM of the benchmark's points, worked out from their discrete logs.

It imports nothing of the program under test and takes nothing that the
program made. The curve comes from the configuration file (``Curve``), the
points' logs from the point generator's parameters (``points.PointSet``), and
the scalars from the traffic generator, as u16 word arrays [n, W].

Every point of a configuration is P_i = e_i G with e_i = a + pi(i) d mod r
(``points.py``), so the MSM is

    sum_i k_i P_i = (sum_i k_i e_i mod r) G = (a sum_i k_i + d sum_i k_i pi(i)) G

``msm_of_words`` computes the two sums over the word columns in numpy
(exact: each block's column sums stay below 2^63) and finishes with one
double-and-add ladder. ``msm_direct`` is the naive sum of scalar multiples
that the tests hold it to at small n.

The control (``control_words``) is this reference put in the program's place
with one guarantee of the configuration broken: the result is exact for
every scalar in [0, r); the control drops each scalar's lowest 16-bit word,
as an MSM that skipped its lowest window would.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

#: rows summed in one block: a column sum of 16-bit words times weights
#: below MAX_WEIGHT stays below 2^16 * 2^30 * 2^16 < 2^63 (int64)
BLOCK_ROWS = 1 << 16
MAX_WEIGHT = 1 << 30


@dataclass(frozen=True)
class Curve:
    """y^2 = x^3 + a x + b over GF(p), a subgroup of prime order r with
    generator (gx, gy). Points are Jacobian (X, Y, Z), the identity Z = 0."""

    name: str
    p: int
    r: int
    a: int
    b: int
    gx: int
    gy: int

    @classmethod
    def from_config(cls, conf: dict) -> "Curve":
        c = conf["curve"]
        return cls(c["name"], *(int(c[k]) for k in ("modulus", "order", "a", "b", "gx", "gy")))

    @property
    def g(self) -> tuple[int, int, int]:
        return (self.gx, self.gy, 1)

    def on_curve(self, x: int, y: int) -> bool:
        return (y * y - x * x * x - self.a * x - self.b) % self.p == 0

    def double(self, P):
        """dbl-2009-l (a = 0), or the general Jacobian doubling."""
        p = self.p
        x1, y1, z1 = P
        if z1 == 0 or y1 == 0:
            return (0, 1, 0)
        xx, yy = x1 * x1 % p, y1 * y1 % p
        yyyy = yy * yy % p
        s = 2 * ((x1 + yy) * (x1 + yy) - xx - yyyy) % p
        m = (3 * xx + self.a * pow(z1, 4, p)) % p
        x3 = (m * m - 2 * s) % p
        y3 = (m * (s - x3) - 8 * yyyy) % p
        z3 = 2 * y1 * z1 % p
        return (x3, y3, z3)

    def add(self, P, Q):
        """add-2007-bl with the identity, doubling and inverse cases."""
        p = self.p
        if P[2] == 0:
            return Q
        if Q[2] == 0:
            return P
        x1, y1, z1 = P
        x2, y2, z2 = Q
        z1z1, z2z2 = z1 * z1 % p, z2 * z2 % p
        u1, u2 = x1 * z2z2 % p, x2 * z1z1 % p
        s1, s2 = y1 * z2 * z2z2 % p, y2 * z1 * z1z1 % p
        if u1 == u2:
            return self.double(P) if s1 == s2 else (0, 1, 0)
        h = (u2 - u1) % p
        i = 4 * h * h % p
        j = h * i % p
        rr = 2 * (s2 - s1) % p
        v = u1 * i % p
        x3 = (rr * rr - j - 2 * v) % p
        y3 = (rr * (v - x3) - 2 * s1 * j) % p
        z3 = ((z1 + z2) * (z1 + z2) - z1z1 - z2z2) * h % p
        return (x3, y3, z3)

    def mul(self, P, k: int):
        """k P by double-and-add, most significant bit first."""
        acc = (0, 1, 0)
        for bit in bin(k)[2:] if k else "":
            acc = self.double(acc)
            if bit == "1":
                acc = self.add(acc, P)
        return acc

    def affine(self, P) -> tuple[int, int] | None:
        """Affine (x, y), or None for the identity."""
        x, y, z = P
        if z % self.p == 0:
            return None
        zi = pow(z, -1, self.p)
        zi2 = zi * zi % self.p
        return (x * zi2 % self.p, y * zi2 * zi % self.p)


def words_to_ints(words: np.ndarray) -> list[int]:
    """u16 words [n, W] (little-endian, any integer dtype) -> n ints."""
    w = np.ascontiguousarray(np.asarray(words).astype("<u2"))
    return [int.from_bytes(row.tobytes(), "little") for row in w]


def _weighted_sum(words: np.ndarray, weights: np.ndarray | None) -> int:
    """sum_i k_i w_i (w_i = 1 where ``weights`` is None) as an exact int,
    for k_i the u16 words [n, W] and 0 <= w_i < MAX_WEIGHT: column sums in
    int64 blocks of BLOCK_ROWS rows."""
    if weights is not None and weights.size and not (0 <= weights.min() and weights.max() < MAX_WEIGHT):
        raise ValueError("weights outside [0, 2^30)")
    total = 0
    W = words.shape[1]
    for lo in range(0, words.shape[0], BLOCK_ROWS):
        blk = words[lo : lo + BLOCK_ROWS].astype(np.int64) & 0xFFFF
        if weights is not None:
            blk = blk * weights[lo : lo + BLOCK_ROWS, None]
        cols = blk.sum(axis=0)
        total += sum(int(cols[j]) << (16 * j) for j in range(W))
    return total


def log_of_msm(words: np.ndarray, a: int, d: int, perm: np.ndarray, r: int) -> int:
    """sum_i k_i e_i mod r for e_i = a + perm[i] d: the discrete log of the
    MSM of scalar words [n, W] over the point set (a, d, perm)."""
    return (a * _weighted_sum(words, None) + d * _weighted_sum(words, perm.astype(np.int64))) % r


def msm_of_words(curve: Curve, words: np.ndarray, a: int, d: int, perm: np.ndarray):
    """The affine MSM (x, y), or None, of scalar words [n, W] over the
    point set with logs a + perm[i] d."""
    return curve.affine(curve.mul(curve.g, log_of_msm(words, a, d, perm, curve.r)))


def msm_direct(curve: Curve, points: list[tuple[int, int]], scalars: list[int]):
    """sum_i k_i P_i as the sum of n double-and-add ladders (affine or
    None): the slow, obvious MSM that ``msm_of_words`` is tested against."""
    acc = (0, 1, 0)
    for (x, y), k in zip(points, scalars):
        acc = curve.add(acc, curve.mul((x, y, 1), k % curve.r))
    return curve.affine(acc)


def control_words(words: np.ndarray) -> np.ndarray:
    """The control's scalars: each scalar's lowest 16-bit word set to 0."""
    out = np.array(words, copy=True)
    out[:, 0] = 0
    return out
