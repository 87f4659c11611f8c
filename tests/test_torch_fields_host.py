"""The generic word core (msm_tpu_torch/csrc/fe32.cuh over the traits of
csrc/fields.cuh) compiled for the host with g++ for all seven fields and
held against Python integers: the Montgomery product a b R^-1 (word CIOS,
with the carry word for secp256k1, then the TAIL-bit REDC step), the
dedicated squaring, add, sub, neg, double, the 3b multiple (Grumpkin's
negative 3b included), the full reduction of any value below 2^(32 NW),
the 13-bit limb <-> word repacking, the dense-word load and the balanced
limb load. Random values and the edges 0, 1, p - 1, 2^(32 NW) - 1 and the
values next to 2p and 4p (secp256k1's sums carry out of the top word;
Pallas' 4p does not fit 256 bits)."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from _torch_helpers import rand_balanced
from msm_tpu_torch.ops._build import FIELD_FLAGS, curve_id
from msm_tpu_torch.params import CURVES, MsmConfig
from msm_tpu_torch.utils.limbs import ints_to_limbs, limbs_to_int

CSRC = Path(__file__).resolve().parent.parent / "msm_tpu_torch" / "csrc"

HARNESS = r"""
#include "fe32.cuh"
using namespace msm;

template <class F>
static void ld(fe32t<F>& x, const uint32_t* w) {
  for (int i = 0; i < F::NW; ++i) x.w[i] = w[i];
}
template <class F>
static void st(uint32_t* o, const fe32t<F>& x) {
  for (int i = 0; i < F::NW; ++i) o[i] = x.w[i];
}

// o [n, 7, NW]: a b, a^2 (dedicated squaring), a + b, a - b, -a, 2a, 3b a
template <class F>
struct Arith {
  static void run(const uint32_t* a, const uint32_t* b, uint32_t* o, int64_t n) {
    constexpr int NW = F::NW;
    for (int64_t i = 0; i < n; ++i) {
      fe32t<F> x, y, r[7];
      ld(x, a + i * NW);
      ld(y, b + i * NW);
      fe32_mul(r[0], x, y);
      fe32_sqr_sym(r[1], x);
      fe32_add(r[2], x, y);
      fe32_sub(r[3], x, y);
      fe32_neg(r[4], x);
      fe32_double(r[5], x);
      fe32_mul_b3(r[6], x);
      for (int k = 0; k < 7; ++k) st(o + (i * 7 + k) * NW, r[k]);
    }
  }
};

// any value below 2^(32 NW) -> mod p
template <class F>
struct Reduce {
  static void run(const uint32_t* a, uint32_t* o, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
      fe32t<F> x;
      ld(x, a + i * F::NW);
      fe32_reduce_full(x);
      st(o + i * F::NW, x);
    }
  }
};

// canonical words [n, NW] -> dense load -> limbs [n, L] -> words [n, NW]
template <class F>
struct Repack {
  static void run(const int32_t* dense, int32_t* limbs, uint32_t* words,
                  int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
      fe32t<F> x, y;
      fe32_load_dense(x, dense + i * F::NW);
      uint32_t v[F::L];
      fe32_to_limbs(v, x);
      for (int j = 0; j < F::L; ++j) limbs[i * F::L + j] = (int32_t)v[j];
      fe32_from_limbs(y, v);
      st(words + i * F::NW, y);
    }
  }
};

// balanced limbs [n, L] -> canonical words [n, NW]
template <class F>
struct Balanced {
  static void run(const int32_t* a, uint32_t* o, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
      fe32t<F> x;
      fe32_from_balanced(x, a + i * F::L);
      st(o + i * F::NW, x);
    }
  }
};

template <template <class> class OP, class... A>
static void dispatch(int curve, A... args) {
  switch (curve) {
    case FpBn254::ID: OP<FpBn254>::run(args...); break;
    case FpBls12_377::ID: OP<FpBls12_377>::run(args...); break;
    case FpPallas::ID: OP<FpPallas>::run(args...); break;
    case FpBls12_381::ID: OP<FpBls12_381>::run(args...); break;
    case FpSecp256k1::ID: OP<FpSecp256k1>::run(args...); break;
    case FpGrumpkin::ID: OP<FpGrumpkin>::run(args...); break;
    case FpVesta::ID: OP<FpVesta>::run(args...); break;
  }
}

extern "C" {
void h_arith(int c, const uint32_t* a, const uint32_t* b, uint32_t* o, int64_t n) {
  dispatch<Arith>(c, a, b, o, n);
}
void h_reduce(int c, const uint32_t* a, uint32_t* o, int64_t n) {
  dispatch<Reduce>(c, a, o, n);
}
void h_repack(int c, const int32_t* d, int32_t* l, uint32_t* w, int64_t n) {
  dispatch<Repack>(c, d, l, w, n);
}
void h_balanced(int c, const int32_t* a, uint32_t* o, int64_t n) {
  dispatch<Balanced>(c, a, o, n);
}
}
"""

NAMES = list(CURVES)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available")
    d = tmp_path_factory.mktemp("fields_host")
    src, so = d / "harness.cpp", d / "harness.so"
    src.write_text(HARNESS)
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC", *FIELD_FLAGS, f"-I{CSRC}", "-o", str(so), str(src)],
                   check=True, capture_output=True, text=True, timeout=600)
    lib = ctypes.CDLL(str(so))
    P, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for name, nargs in (("h_arith", 3), ("h_reduce", 2), ("h_repack", 3), ("h_balanced", 2)):
        fn = getattr(lib, name)
        fn.argtypes = [I32] + [P] * nargs + [I64]
        fn.restype = None
    return lib


def _nw(cfg) -> int:
    return (cfg.curve.modulus_bits + 31) // 32


def _words(vals, nw) -> np.ndarray:
    return np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(nw)] for v in vals], dtype=np.uint32)


def _ints(words) -> list[int]:
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) for row in np.asarray(words)]


def _run(lib, name, cfg, out_shape, out_dtype, *arrays):
    out = np.zeros(out_shape, dtype=out_dtype)
    getattr(lib, name)(curve_id(cfg), *(np.ascontiguousarray(a).ctypes.data for a in arrays),
                       out.ctypes.data, out_shape[0])
    return out


def _cfg(name):
    return MsmConfig(curve=CURVES[name])


def _canonical_values(rng, p: int, count: int) -> list[int]:
    edges = [0, 1, 2, p - 1, p - 2, (p - 1) // 2, (p + 1) // 2]
    return edges + [int.from_bytes(rng.bytes(64), "little") % p for _ in range(count)]


@pytest.mark.parametrize("name", NAMES)
def test_arithmetic_matches_integers(lib, name):
    """a b R^-1, a^2 R^-1, a + b, a - b, -a, 2a and 3b a mod p for canonical
    a, b (every pair of the edge values, and random ones), canonical out."""
    cfg = _cfg(name)
    p, nw, rinv = cfg.curve.modulus, _nw(cfg), pow(cfg.r, -1, cfg.curve.modulus)
    rng = np.random.default_rng(7)
    vals = _canonical_values(rng, p, 200)
    a = vals + [x for x in vals[:7] for _ in range(7)]
    b = vals[::-1] + vals[:7] * 7
    out = _run(lib, "h_arith", cfg, (len(a), 7, nw), np.uint32, _words(a, nw), _words(b, nw))
    b3 = 3 * cfg.curve.b % p
    for i, (x, y) in enumerate(zip(a, b)):
        got = _ints(out[i])
        want = [x * y * rinv % p, x * x * rinv % p, (x + y) % p, (x - y) % p, -x % p, 2 * x % p, b3 * x % p]
        assert got == want, (name, i, x, y)


@pytest.mark.parametrize("name", NAMES)
def test_reduce_full_covers_every_word_value(lib, name):
    """fe32_reduce_full on values anywhere in [0, 2^(32 NW)): the edges 0,
    p - 1, p, 2^(32 NW) - 1 and the values next to 2p, 4p and 8p that fit,
    and random ones; the result is the value mod p."""
    cfg = _cfg(name)
    p, nw = cfg.curve.modulus, _nw(cfg)
    top = 1 << (32 * nw)
    rng = np.random.default_rng(8)
    vals = [0, 1, p - 1, p, p + 1, top - 1, top - 2, top - p, top - p - 1]
    vals += [k * p + d for k in (2, 3, 4, 5, 8) for d in (-1, 0, 1) if 0 <= k * p + d < top]
    vals += [int.from_bytes(rng.bytes(4 * nw), "little") for _ in range(300)]
    out = _run(lib, "h_reduce", cfg, (len(vals), nw), np.uint32, _words(vals, nw))
    assert _ints(out) == [v % p for v in vals]


@pytest.mark.parametrize("name", NAMES)
def test_limb_and_dense_repacking(lib, name):
    """Canonical words (the packed table's dense form) -> 13-bit limbs ->
    words, against the integers' own limbs."""
    cfg = _cfg(name)
    p, nw, L = cfg.curve.modulus, _nw(cfg), cfg.num_words
    vals = _canonical_values(np.random.default_rng(9), p, 100)
    dense = _words(vals, nw).view(np.int32)
    limbs = np.zeros((len(vals), L), dtype=np.int32)
    words = np.zeros((len(vals), nw), dtype=np.uint32)
    getattr(lib, "h_repack")(curve_id(cfg), dense.ctypes.data, limbs.ctypes.data, words.ctypes.data, len(vals))
    assert np.array_equal(limbs, ints_to_limbs(vals, cfg.word_size, L).astype(np.int32))
    assert _ints(words) == vals


@pytest.mark.parametrize("name", NAMES)
def test_balanced_limbs_load_canonical(lib, name):
    """fe32_from_balanced on balanced limbs (signed, a little outside
    [0, 2^13), negative values included) and on canonical ones: the value
    mod p."""
    cfg = _cfg(name)
    p, nw, L = cfg.curve.modulus, _nw(cfg), cfg.num_words
    rng = np.random.default_rng(10)
    bal = rand_balanced(rng, (300,), cfg)
    canon = ints_to_limbs(_canonical_values(rng, p, 20), cfg.word_size, L).astype(np.int32)
    top = np.full((2, L), (1 << cfg.word_size) - 1, dtype=np.int32)  # 2^(13 L) - 1
    top[1, -1] = -1  # -(2^(13 (L - 1))) + lower limbs
    a = np.concatenate([bal, canon, top])
    out = _run(lib, "h_balanced", cfg, (len(a), nw), np.uint32, a)
    assert _ints(out) == [limbs_to_int(row, cfg.word_size) % p for row in a]
