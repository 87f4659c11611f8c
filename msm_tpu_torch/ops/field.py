"""Batched prime-field arithmetic on int32 limb tensors — the plain PyTorch
port of ``msm_tpu/ops/field.py`` (``FieldCtx``, lazy-reduction Montgomery).

Representation, as in the reference: int32 ``[..., L]`` tensors of
``word_size``-bit limbs, little-endian, BALANCED — limbs may be slightly out
of range or negative and the value is only bounded (|value| <~ 32p), kept
there by one carry sweep per op and the top-limb renormalization fold after
every Montgomery product. ``canonical`` is the exit path.

The algorithms are the reference's step for step, so outputs are
bit-identical to ``msm_tpu.ops.field.FieldCtx`` (not only congruent). This
module is the field layer of the kernels' plain twins and runs on any
device; the CUDA kernels carry their own fully-reducing core
(``csrc/field.cuh``).

Beside the lazy Montgomery product, as in the reference: ``barrett_mul``
(canonical in, canonical out) and Fermat's ``inv_standard``, and the
wide-word multiplier family for word sizes 13 to 16 (``mont_mul_eager``,
``mont_mul_nsafe`` and their parts), which the reference computes in
uint32 lanes. PyTorch has no uint32 arithmetic, so these run in int64
lanes that hold the uint32 values, cut to 32 bits after every step where
a uint32 lane wraps: the reference's bits exactly.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from msm_tpu_torch.ops import bigint
from msm_tpu_torch.params import MsmConfig
from msm_tpu_torch.utils.limbs import int_to_limbs


class FieldCtx:
    """Field arithmetic for one (curve, limb-geometry) config."""

    def __init__(self, cfg: MsmConfig):
        # the lazy product's int32 columns: 14- to 16-bit limbs raise
        # ValueError here, before any work, as in the reference
        bigint.check_overflow_budget(cfg.word_size, cfg.num_words)
        self.cfg = cfg
        self.w = cfg.word_size
        self.L = cfg.num_words
        self.mask = cfg.mask
        p = cfg.curve.modulus
        assert (1 << (self.w * self.L)) >= 64 * p, "need R >= 64p"
        self.p_limbs = self._limbs(p)
        self.r_limbs = self._limbs(cfg.r)  # Montgomery form of 1
        self.r2_limbs = self._limbs(cfg.r2)
        self.rinv_limbs = self._limbs(cfg.rinv)
        self.one_limbs = self._limbs(1)
        self.zero_limbs = self._limbs(0)
        self.n0 = int(cfg.n0)
        # top-limb renormalization fold (reference field.py:81-89)
        self.fold_s = max(0, p.bit_length() + 3 - self.w * (self.L - 1))
        assert self.fold_s < self.w, (self.fold_s, self.w, self.L)
        self.fold_c = self._limbs((1 << (self.w * (self.L - 1) + self.fold_s)) % p)
        # Barrett: mu = floor(4^k / p), k the bit length of p
        self.k = cfg.curve.modulus_bits
        self.mu_limbs = self._limbs(cfg.mu, max(self.L + 1, -(-(self.k + 2) // self.w) + 1))
        self._dev: dict[tuple[bytes, torch.device], torch.Tensor] = {}

    def _limbs(self, x: int, words: int | None = None) -> np.ndarray:
        return int_to_limbs(x, self.w, words or self.L).astype(np.int32)

    def const(self, limbs: np.ndarray, device) -> torch.Tensor:
        """A constant limb vector as an int32 tensor on ``device`` (cached by
        value)."""
        key = (limbs.tobytes(), torch.device(device))
        t = self._dev.get(key)
        if t is None:
            t = torch.from_numpy(limbs).to(device)
            self._dev[key] = t
        return t

    # -- lazy basic ops -----------------------------------------------------

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return bigint.sweep(a + b, self.w)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return bigint.sweep(a - b, self.w)

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        return -a

    def double(self, a: torch.Tensor) -> torch.Tensor:
        return self.add(a, a)

    # -- Montgomery core ----------------------------------------------------

    def mont_mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a*b*R^-1 mod p on balanced limbs: the reference's fused CIOS
        (one sweep per limb step), then the residual-column fold, a sweep
        and the top-limb renormalization. The steps run limb-major (each
        limb of the batch a contiguous row), on CPU tensors through numpy,
        whose small-array ops cost a fraction of torch's; the same int32
        operations either way, so the result is the same bit for bit."""
        a, b = torch.broadcast_tensors(a, b)
        shape, L = a.shape, self.L
        if a.device.type == "cpu":
            aT, bT = (np.ascontiguousarray(t.reshape(-1, L).numpy().T) for t in (a, b))
            out = self._cios(aT, bT, self.p_limbs[:, None], self.fold_c[:, None],
                             lambda rows: np.zeros((rows, aT.shape[1]), np.int32))
            return torch.from_numpy(np.ascontiguousarray(out.T)).reshape(shape)
        dev = a.device
        aT, bT = (t.reshape(-1, L).T.contiguous() for t in (a, b))
        out = self._cios(aT, bT, self.const(self.p_limbs, dev)[:, None], self.const(self.fold_c, dev)[:, None],
                         lambda rows: torch.zeros((rows, aT.shape[1]), dtype=torch.int32, device=dev))
        return out.T.contiguous().reshape(shape)

    def _cios(self, a, b, q, fold_c, zeros):
        """``mont_mul``'s steps on limb-major int32 arrays [L, B] of either
        kind (torch tensors or numpy arrays: the same operators, the same
        wrapping); ``q``, ``fold_c`` are columns [L, 1]."""
        w, L, mask = self.w, self.L, self.mask

        def sweep(x):  # bigint.sweep along the limb axis
            carry = x >> w
            out = x & mask
            out[1:] += carry[:-1]
            out[-1] += carry[-1] << w
            return out

        # the reference shifts an (L+1)-limb accumulator down one limb per
        # step; here the same accumulator is the window buf[i : i+L+1] of a
        # zeroed buffer, updated in place (the consumed limb stays behind)
        buf = zeros(2 * L + 1)
        for i in range(L):
            acc = buf[i : i + L + 1]
            acc[:L] += a[i] * b
            carry = acc >> w
            acc &= mask
            acc[1:] += carry[:-1]
            acc[L] += carry[L] << w
            m = ((acc[0] & mask) * self.n0) & mask
            acc[:L] += m * q
            acc[1] += acc[0] >> w  # low limb is 0 mod 2^w now
        acc = buf[L:]
        out = acc[:L]  # the buffer's last use: updated in place
        out[L - 1] += acc[L] << w
        out = sweep(out)
        k = out[L - 1] >> self.fold_s
        out[L - 1] -= k << self.fold_s
        return sweep(out + k * fold_c)

    def mont_sqr(self, a: torch.Tensor) -> torch.Tensor:
        return self.mont_mul(a, a)

    def to_mont(self, a: torch.Tensor) -> torch.Tensor:
        """a -> a*R mod p."""
        return self.mont_mul(a, self.const(self.r2_limbs, a.device))

    def from_mont(self, a: torch.Tensor) -> torch.Tensor:
        """a*R -> a."""
        return self.mont_mul(a, self.const(self.one_limbs, a.device))

    def mont_pow(self, a: torch.Tensor, e: int) -> torch.Tensor:
        """Montgomery exponentiation by a static exponent e >= 0:
        square-and-multiply over e's bits, MSB first, so pow(aR, e) =
        a^e R (reference ``FieldCtx.mont_pow``; congruent to it, since the
        squaring here is the general product)."""
        acc = self.const(self.r_limbs, a.device).expand(a.shape)
        for bit in bin(e)[2:]:
            acc = self.mont_mul(acc, acc)
            if bit == "1":
                acc = self.mont_mul(acc, a)
        return acc

    # -- exit path ----------------------------------------------------------

    def canonical(self, a: torch.Tensor) -> torch.Tensor:
        """Balanced limbs -> canonical limbs of (value mod p): two Montgomery
        products squeeze the value into (-eps*p, (1+eps)*p), then +p, a carry
        chain and two carry-aware conditional subtracts."""
        w = self.w
        dev = a.device
        p = self.const(self.p_limbs, dev)
        z = self.mont_mul(
            self.mont_mul(a, self.const(self.r2_limbs, dev)),
            self.const(self.one_limbs, dev),
        )
        limbs, carry = bigint.carry_propagate(z + p, w)
        for _ in range(2):
            d, borrow = bigint.sub(limbs, p, w)
            need = (carry > 0) | (borrow == 0)
            limbs = torch.where(need[..., None], d, limbs)
            carry = torch.where(need & (borrow == 1), carry - 1, carry)
        return limbs

    def is_zero(self, a: torch.Tensor) -> torch.Tensor:
        return torch.all(self.canonical(a) == 0, dim=-1)

    def eq(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.is_zero(self.sub(a, b))

    # -- Barrett multiplier (canonical in, canonical out) ----------------------

    def reduce(self, a: torch.Tensor) -> torch.Tensor:
        """Canonical limbs of a value in [0, 2p) that fits L limbs: one
        conditional subtract of p."""
        d, borrow = bigint.sub(a, self.const(self.p_limbs, a.device), self.w)
        return torch.where((borrow == 0)[..., None], d, a)

    def barrett_mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a*b mod p by Barrett reduction, canonical limbs in and out:
        x = a*b; l = ((x >> (k-1)) * mu) >> (k+1); r = x - l*p (below 3p);
        two conditional subtracts."""
        w, L, k = self.w, self.L, self.k
        dev = a.device
        pext = self.const(np.append(self.p_limbs, np.int32(0)), dev)
        x = bigint.mul(a, b, w)  # [..., 2L]
        xh = bigint.shr_bits(x, k - 1, w, L + 1)
        l = bigint.shr_bits(bigint.mul(xh, self.const(self.mu_limbs[: L + 1], dev), w), k + 1, w, L + 1)
        lp = bigint.mul(l, pext, w)  # [..., 2L + 2]
        xext = torch.cat([x, torch.zeros_like(lp[..., x.shape[-1] :])], dim=-1)
        r = bigint.sub(xext, lp, w)[0][..., : L + 1]
        for _ in range(2):
            d, borrow = bigint.sub(r, pext, w)
            r = torch.where((borrow == 0)[..., None], d, r)
        return r[..., :L]

    def inv_standard(self, a: torch.Tensor) -> torch.Tensor:
        """a^-1 mod p, canonical in and out, by Fermat (a^(p-2))."""
        inv_m = self.mont_pow(self.to_mont(a), self.cfg.curve.modulus - 2)
        return self.canonical(self.from_mont(inv_m))


# -- the wide-word multipliers (word sizes 13 to 16, uint32 in the reference) --

_U32 = 0xFFFFFFFF


def _u32(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of an int64 lane: what a uint32 lane holds."""
    return x & _U32


@functools.lru_cache(maxsize=None)
def _modulus_limbs(cfg: MsmConfig, device: torch.device) -> torch.Tensor:
    """p's limbs as int64 on ``device``, made once per (config, device):
    shared, so read only."""
    return torch.from_numpy(int_to_limbs(cfg.curve.modulus, cfg.word_size, cfg.num_words).astype(np.int64)).to(device)


def _as_u32_lanes(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Broadcast int32 limb tensors ``[..., L]``, as uint32 values in int64
    (``MsmConfig`` keeps word_size <= 16, so a limb product fits 32 bits)."""
    a, b = torch.broadcast_tensors(a, b)
    return _u32(a.long()), _u32(b.long())


def _carry_chain(acc: torch.Tensor, w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A serial uint32 carry chain over the limbs: (limbs < 2^w, carry out)."""
    mask = (1 << w) - 1
    out = torch.empty_like(acc)
    c = torch.zeros_like(acc[..., 0])
    for j in range(acc.shape[-1]):
        v = _u32(acc[..., j] + c)
        out[..., j] = v & mask
        c = v >> w
    return out, c


def _conditional_sub_p(cfg: MsmConfig, acc: torch.Tensor) -> torch.Tensor:
    """The low L uint32 limbs as int32, less p where that leaves no borrow."""
    out = acc[..., : cfg.num_words].to(torch.int32)
    d, borrow = bigint.sub(out, _modulus_limbs(cfg, out.device).to(torch.int32), cfg.word_size)
    return torch.where((borrow == 0)[..., None], d, out)


def mont_mul_eager(cfg: MsmConfig, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Classic CIOS Montgomery product with a carry chain after every
    multiply-accumulate (the reference's eager uint32 variant): canonical
    limbs in (each below 2^w, value below p), canonical int32 limbs out,
    word sizes up to 16."""
    w, L = cfg.word_size, cfg.num_words
    au, bu = _as_u32_lanes(a, b)
    q = _modulus_limbs(cfg, au.device)
    acc = torch.zeros(au.shape[:-1] + (L + 2,), dtype=torch.int64, device=au.device)
    for i in range(L):
        acc[..., :L] = _u32(acc[..., :L] + _u32(au[..., i : i + 1] * bu))
        acc = _carry_chain(acc, w)[0]
        m = (acc[..., 0] * cfg.n0) & cfg.mask
        acc[..., :L] = _u32(acc[..., :L] + _u32(m[..., None] * q))
        acc = _carry_chain(acc, w)[0]
        # the low limb is 0 now: shift the window down one limb
        acc = torch.cat([acc[..., 1:], torch.zeros_like(acc[..., :1])], dim=-1)
    return _conditional_sub_p(cfg, acc)  # below 2p: one subtract


def nsafe_for(word_size: int) -> int:
    """How many limb products a uint32 column holds before a carry pass
    (the reference's nSafe): 13 -> 64, 14 -> 16, 15 -> 4, 16 -> 1."""
    return max(1, ((1 << 32) - 1) // ((1 << word_size) - 1) ** 2)


def _u32_norm(acc: torch.Tensor, w: int) -> torch.Tensor:
    """uint32 limb columns (int64 lanes) carried to limbs below 2^w; the top
    limb keeps the carry out, shifted up by w (wrapping at 2^32 as a uint32
    lane does)."""
    out, carry = _carry_chain(acc, w)
    out[..., -1] = _u32(out[..., -1] + _u32(carry << w))
    return out


def mul_wide_nsafe(cfg: MsmConfig, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The full 2L-limb schoolbook product, carries passed once every
    ``nsafe_for(w)`` products (the reference's nSafe grouped product).
    Canonical limbs in; out: the canonical 2L limbs as uint32 values in
    int64 lanes."""
    w, L = cfg.word_size, cfg.num_words
    ns = nsafe_for(w)
    au, bu = _as_u32_lanes(a, b)
    acc = torch.zeros(au.shape[:-1] + (2 * L,), dtype=torch.int64, device=au.device)
    for g0 in range(0, L, ns):
        for i in range(g0, min(g0 + ns, L)):
            acc[..., i : i + L] = _u32(acc[..., i : i + L] + _u32(au[..., i : i + 1] * bu))
        acc = _u32_norm(acc, w)
    return acc


def mont_reduce_wide(cfg: MsmConfig, t: torch.Tensor) -> torch.Tensor:
    """Montgomery reduction of a full 2L-limb value T below p*R: T*R^-1 mod
    p as canonical int32 limbs (the reference's windowed uint32 reduce;
    ``t`` int32 limbs or ``mul_wide_nsafe``'s int64 lanes)."""
    w, L = cfg.word_size, cfg.num_words
    if t.shape[-1] != 2 * L:
        raise ValueError(f"expected [..., {2 * L}] limbs, got {tuple(t.shape)}")
    tu = _u32(t.long())
    q = _modulus_limbs(cfg, tu.device)
    # a window of L+2 limbs from REDC step i; the limbs above it enter as
    # the window shifts down
    acc = tu[..., : L + 2].clone()
    xs = torch.cat([tu[..., L + 2 :], torch.zeros_like(tu[..., :2])], dim=-1)
    for i in range(L):
        m = (acc[..., 0] * cfg.n0) & cfg.mask
        acc[..., :L] = _u32(acc[..., :L] + _u32(m[..., None] * q))
        acc = _u32_norm(acc, w)
        acc = torch.cat([acc[..., 1:], xs[..., i : i + 1]], dim=-1)
    return _conditional_sub_p(cfg, acc)  # below 2p: one subtract


def mont_mul_nsafe(cfg: MsmConfig, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """nSafe Montgomery product: ``mul_wide_nsafe`` then
    ``mont_reduce_wide``. Canonical in and out; word sizes 13 to 16."""
    return mont_reduce_wide(cfg, mul_wide_nsafe(cfg, a, b))


@functools.lru_cache(maxsize=None)
def get_field_ctx(cfg: MsmConfig) -> FieldCtx:
    return FieldCtx(cfg)
