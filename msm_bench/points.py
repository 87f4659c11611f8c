"""The configuration's fixed point set: n distinct points with known
discrete logs, made once from the configuration's own seed and cached.

Point i is P_i = e_i G with e_i = a + pi(i) d mod r, where a and d are
drawn from ``points_seed`` and pi is a permutation of [0, n) drawn from it
too. So the points are distinct (e_i are distinct, none is 0, and no two
are opposite for a, d drawn at random), lie in the order-r subgroup, and
their MSM has a log the reference works out in numpy (``reference.py``).

The points Q_j = (a + j d) G, j in [0, n), are made as T chains of
consecutive j, each stepping by D = d G, all chains one affine addition at
a time with one batched inversion a step, the chains split over worker
processes. Point i is Q_pi(i). The set is written once, as little-endian
x || y bytes a point, to ``_cache/points/`` inside the benchmark's folder,
with the SHA-256 of the file beside it; a later run checks the hash and a
sample of the points against their logs.
"""

from __future__ import annotations

import hashlib
import json
import multiprocessing
import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from msm_bench.reference import Curve

CACHE = Path(__file__).resolve().parent / "_cache" / "points"
#: the generator's format; part of the cache key
VERSION = 1
#: chains stepped in lockstep (at most n)
CHAINS = 1 << 12
#: below this many points the set is made in this process
POOL_MIN = 1 << 14
#: points checked against e_i G on every load
SAMPLE = 8


@dataclass(frozen=True)
class PointSet:
    """The parameters of a configuration's points: P_i = (a + perm[i] d) G."""

    curve: Curve
    n: int
    seed: int
    a: int
    d: int
    perm: np.ndarray

    @classmethod
    def from_config(cls, conf: dict) -> "PointSet":
        curve = Curve.from_config(conf)
        n, seed = 1 << int(conf["log_n"]), int(conf["points_seed"])
        rng = np.random.default_rng(seed)
        a = 1 + int.from_bytes(rng.bytes(48), "little") % (curve.r - 1)
        d = 1 + int.from_bytes(rng.bytes(48), "little") % (curve.r - 1)
        return cls(curve, n, seed, a, d, rng.permutation(n))

    def log(self, i: int) -> int:
        return (self.a + int(self.perm[i]) * self.d) % self.curve.r

    @property
    def coord_bytes(self) -> int:
        return (self.curve.p.bit_length() + 7) // 8

    @property
    def key(self) -> str:
        c = self.curve
        h = hashlib.sha256(json.dumps([VERSION, c.name, c.p, c.r, c.gx, c.gy, self.n, self.seed]).encode())
        return f"{c.name}_{self.n.bit_length() - 1}_{h.hexdigest()[:16]}"


def _chains(args) -> bytes:
    """Chains t0..t1-1 of m points each (chain t holds Q_{t m} ..
    Q_{t m + m - 1}) as x || y bytes, chain after chain."""
    curve, a, d, m, t0, t1, cb = args
    p = curve.p
    start = curve.affine(curve.mul(curve.g, (a + t0 * m * d) % curve.r))
    hop = curve.affine(curve.mul(curve.g, m * d % curve.r))
    xd, yd = curve.affine(curve.mul(curve.g, d))
    xs, ys = [start[0]], [start[1]]
    for _ in range(t1 - t0 - 1):  # chain starts, one hop apart
        x, y = curve.affine(curve.add((xs[-1], ys[-1], 1), (*hop, 1)))
        xs.append(x)
        ys.append(y)
    T = len(xs)
    rows = np.empty((m, T, 2 * cb), np.uint8)
    for s in range(m):
        rows[s, :, :cb] = np.frombuffer(b"".join(x.to_bytes(cb, "little") for x in xs), np.uint8).reshape(T, cb)
        rows[s, :, cb:] = np.frombuffer(b"".join(y.to_bytes(cb, "little") for y in ys), np.uint8).reshape(T, cb)
        if s == m - 1:
            break
        den = [(xd - x) % p for x in xs]
        prefix, acc = [0] * T, 1
        for i, v in enumerate(den):
            if v == 0:
                raise ValueError("a chain met +-D: draw another points_seed")
            prefix[i] = acc
            acc = acc * v % p
        inv = pow(acc, -1, p)
        nx, ny = [0] * T, [0] * T
        for i in range(T - 1, -1, -1):
            lam = (yd - ys[i]) * (inv * prefix[i] % p) % p
            inv = inv * den[i] % p
            x3 = (lam * lam - xs[i] - xd) % p
            nx[i], ny[i] = x3, (lam * (xs[i] - x3) - ys[i]) % p
        xs, ys = nx, ny
    return rows.transpose(1, 0, 2).tobytes()


def make(ps: PointSet, workers: int | None = None) -> np.ndarray:
    """The points as uint8 [n, 2 cb] (x || y, little-endian), point i
    being Q_perm[i]."""
    T = min(ps.n, CHAINS)
    m, cb = ps.n // T, ps.coord_bytes
    if workers is None:
        workers = 1 if ps.n < POOL_MIN else min(len(os.sched_getaffinity(0)), T)
    cuts = [T * w // workers for w in range(workers + 1)]
    jobs = [(ps.curve, ps.a, ps.d, m, lo, hi, cb) for lo, hi in zip(cuts, cuts[1:]) if hi > lo]
    if len(jobs) == 1:
        parts = [_chains(jobs[0])]
    else:
        with multiprocessing.get_context("spawn").Pool(len(jobs)) as pool:
            parts = pool.map(_chains, jobs)
            pool.close()
            pool.join()
    q = np.frombuffer(b"".join(parts), np.uint8).reshape(ps.n, 2 * cb)
    return q[ps.perm]


def _digest(path: Path) -> str:
    h = hashlib.sha256()
    with path.open("rb") as f:
        while chunk := f.read(1 << 24):
            h.update(chunk)
    return h.hexdigest()


def load(ps: PointSet, cache: Path = CACHE) -> np.ndarray:
    """The points as uint8 [n, 2 cb]: from the cache when its hash holds,
    else made and written there. A sample of SAMPLE points is checked
    against e_i G either way (``ValueError`` if one differs)."""
    path = cache / f"{ps.key}.bin"
    sums = path.with_suffix(".sha256")
    cb = ps.coord_bytes
    if path.exists() and sums.exists() and sums.read_text().strip() == _digest(path):
        pts = np.fromfile(path, np.uint8).reshape(ps.n, 2 * cb)
    else:
        pts = make(ps)
        cache.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        pts.tofile(tmp)
        os.replace(tmp, path)
        sums.write_text(_digest(path))
    check(ps, pts, np.random.default_rng(ps.seed + 1).choice(ps.n, size=min(SAMPLE, ps.n), replace=False))
    return pts


def check(ps: PointSet, pts: np.ndarray, rows) -> None:
    """Raise ``ValueError`` unless each point of ``rows`` is e_i G."""
    cb = ps.coord_bytes
    for i in map(int, rows):
        want = ps.curve.affine(ps.curve.mul(ps.curve.g, ps.log(i)))
        got = tuple(int.from_bytes(pts[i, k * cb : (k + 1) * cb].tobytes(), "little") for k in (0, 1))
        if got != want:
            raise ValueError(f"point {i} of {ps.key} is not its e_i G")


def as_tuples(ps: PointSet, pts: np.ndarray) -> list[tuple[int, int]]:
    """uint8 [n, 2 cb] -> the (x, y) int pairs that the program's ``plan``
    takes."""
    cb = ps.coord_bytes
    raw = pts.tobytes()
    fb = int.from_bytes
    step = 2 * cb
    return [(fb(raw[o : o + cb], "little"), fb(raw[o + cb : o + step], "little")) for o in range(0, len(raw), step)]
