"""The one traffic generator: a traffic file's parameters and ``--seed`` ->
the pool of scalar vectors that a cell's calls cycle through, each as u16
words [n, W], as a prover holding field elements calls the plan.

A traffic file (``traffic/<name>.json``) holds

- ``batch``: scalar vectors a call takes (1: ``plan(words)``; B > 1:
  ``plan.run_batch`` of B vectors);
- ``pool``: vectors made in set-up (at least 8, a multiple of ``batch``);
  call c takes vectors (c B .. c B + B - 1) mod ``pool``;
- ``mix``: kinds of scalars with their shares of each vector, each
  ``{"share": s, "kind": k, ...}``: ``const`` (``value``), ``range``
  (uniform in [``lo``, ``hi``), hi <= 2^64) or ``uniform`` (uniform in
  [0, r)). Each vector holds exactly round(s n) scalars of each kind (the
  last kind takes the rest) at positions drawn from the seed, so every seed
  gives the same amount of each kind of work.
"""

from __future__ import annotations

import numpy as np

KINDS = ("const", "range", "uniform")


def check(traffic: dict) -> None:
    """Raise ``ValueError`` on a malformed traffic file."""
    b, pool = int(traffic["batch"]), int(traffic["pool"])
    if b < 1 or pool < 8 or pool % b:
        raise ValueError(f"batch {b}, pool {pool}: need pool >= 8, a multiple of batch")
    shares = [float(m["share"]) for m in traffic["mix"]]
    if any(m["kind"] not in KINDS for m in traffic["mix"]) or abs(sum(shares) - 1) > 1e-9 or min(shares) < 0:
        raise ValueError(f"mix {traffic['mix']}: kinds {KINDS}, shares summing to 1")


def uniform_below(rng: np.random.Generator, count: int, r: int, words: int) -> np.ndarray:
    """``count`` scalars uniform in [0, r) as u16 words [count, words]:
    draws of r's bit length, each one at or above r drawn again."""
    limbs = words // 4
    top = r.bit_length() - 64 * (limbs - 1)
    mask = np.uint64((1 << top) - 1) if top < 64 else np.uint64(2**64 - 1)
    r_limbs = [np.uint64((r >> (64 * j)) & (2**64 - 1)) for j in range(limbs)]

    def draw(k: int) -> np.ndarray:
        d = rng.integers(0, 2**64, size=(k, limbs), dtype=np.uint64)
        d[:, -1] &= mask
        return d

    def below(a: np.ndarray) -> np.ndarray:
        lt, eq = np.zeros(len(a), bool), np.ones(len(a), bool)
        for j in reversed(range(limbs)):
            lt |= eq & (a[:, j] < r_limbs[j])
            eq &= a[:, j] == r_limbs[j]
        return lt

    out = draw(count)
    bad = np.flatnonzero(~below(out))
    while bad.size:
        d = draw(bad.size)
        ok = below(d)
        out[bad[ok]] = d[ok]
        bad = bad[~ok]
    return out.view("<u2").reshape(count, words)


def make_vector(rng: np.random.Generator, mix: list[dict], n: int, r: int, words: int) -> np.ndarray:
    """One scalar vector as u16 words [n, words] (``words`` a multiple of
    4)."""
    out = np.zeros((n, words), "<u2")
    order = rng.permutation(n) if len(mix) > 1 else None
    lo = 0
    for j, m in enumerate(mix):
        cnt = n - lo if j == len(mix) - 1 else min(n - lo, round(float(m["share"]) * n))
        rows = order[lo : lo + cnt] if cnt < n else slice(None)
        lo += cnt
        if m["kind"] == "const":
            v = int(m["value"]) % r
            out[rows] = np.frombuffer(v.to_bytes(2 * words, "little"), "<u2")
        elif m["kind"] == "range":
            vals = rng.integers(int(m["lo"]), int(m["hi"]), size=cnt, dtype=np.uint64, endpoint=False)
            out[rows, :4] = vals.view("<u2").reshape(cnt, 4)
        else:
            out[rows] = uniform_below(rng, cnt, r, words)
    return out


def make_pool(traffic: dict, n: int, r: int, seed: int, words: int = 16) -> list[np.ndarray]:
    """The cell's ``pool`` scalar vectors, u16 words [n, words] each, from
    ``seed``."""
    check(traffic)
    rng = np.random.default_rng(seed)
    return [make_vector(rng, traffic["mix"], n, r, words) for _ in range(int(traffic["pool"]))]
