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
        self.cfg = cfg
        self.w = cfg.word_size
        self.L = cfg.num_words
        self.mask = cfg.mask
        p = cfg.curve.modulus
        assert (1 << (self.w * self.L)) >= 64 * p, "need R >= 64p"
        self.p_limbs = self._limbs(p)
        self.r_limbs = self._limbs(cfg.r)  # Montgomery form of 1
        self.r2_limbs = self._limbs(cfg.r2)
        self.one_limbs = self._limbs(1)
        self.zero_limbs = self._limbs(0)
        self.n0 = int(cfg.n0)
        # top-limb renormalization fold (reference field.py:81-89)
        self.fold_s = max(0, p.bit_length() + 3 - self.w * (self.L - 1))
        assert self.fold_s < self.w, (self.fold_s, self.w, self.L)
        self.fold_c = self._limbs((1 << (self.w * (self.L - 1) + self.fold_s)) % p)
        self._dev: dict[tuple[bytes, torch.device], torch.Tensor] = {}

    def _limbs(self, x: int) -> np.ndarray:
        return int_to_limbs(x, self.w, self.L).astype(np.int32)

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


@functools.lru_cache(maxsize=None)
def get_field_ctx(cfg: MsmConfig) -> FieldCtx:
    return FieldCtx(cfg)
