"""The word core (msm_tpu_torch/csrc/fe32.cuh, curve32.cuh) and the per-lane
bodies of the point conversion (kernel 2, csrc/convert32.cuh), the scan
(kernel 4, csrc/scan.cuh), the Horner ladder (kernel 7, csrc/horner.cuh),
the Fermat inversion (kernel 9, csrc/pow32.cuh), the pair forward products,
backward emission and suffix products (kernels 10, 11 and 12,
csrc/pair32.cuh) and the fused pair emission + scan (kernel 13,
csrc/emit_scan.cuh) compiled for the host with g++ and held against the
plain PyTorch twins: the R = 2^260 Montgomery product (word CIOS plus one
4-bit step) and the dedicated squaring on random and edge values, add, sub,
neg, double and the 3b multiple, the 13-bit <-> word repacking and the
dense-word load, the balanced-input load, RCB16 Algorithms 7, 8 and 9, the
conversion of u16 coordinate words (values in [p, 2^256) included) with
compiled-in and run-time constants in each output layout, the scan's body
run for every lane of a small stream, the Horner chain, the windowed
exponentiation on edge bases and exponents, and the pair bodies for every
lane of a stream with doubling and infinity pairs; and the GLV modes of
these bodies (the triple table's conversion, the element loads that take x
or beta x by flag bit 1 from a three-coordinate row, the scan and the four
pair bodies over a GLV table with pairs of equal x across its halves).
Outputs of the core must be canonical and equal to the twins' results after
canonical(): a canonical value is unique, so the kernels on this core write
the limbs the 13-bit core writes."""

import ctypes
import random
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_helpers import glv_pair_stream, mont_limbs, pair_stream, rand_balanced, rand_canonical
from msm_tpu_torch.ops._build import FIELD_FLAGS
from msm_tpu_torch.ops.cuda_bpr import bpr_phase1_plain
from msm_tpu_torch.ops.cuda_compress import (emit_scan_plain, pair_backward_plain, pair_forward_plain,
                                              pair_suffix_plain)
from msm_tpu_torch.ops.cuda_convert import convert_pack_plain, convert_pack_scaled_plain, pack_canonical
from msm_tpu_torch.ops.cuda_inv import mont_pow_plain
from msm_tpu_torch.ops.cuda_curve import b3_mont_limbs, point_add_plain
from msm_tpu_torch.ops.cuda_prefix import horner_plain
from msm_tpu_torch.ops.cuda_scan import rcb16_madd_plain, scan_rows_plain
from msm_tpu_torch.ops.curve import CurveCtx, PointBatch
from msm_tpu_torch.ops.field import get_field_ctx
from msm_tpu_torch.params import BN254, MsmConfig
from msm_tpu_torch.utils.limbs import ints_to_limbs

CSRC = Path(__file__).resolve().parent.parent / "msm_tpu_torch" / "csrc"
CFG = MsmConfig(curve=BN254)
GLV = MsmConfig(curve=BN254, glv=True)
F = get_field_ctx(CFG)
L = CFG.num_words
P = BN254.modulus

HARNESS = r"""
#include <vector>

#include "bpr.cuh"
#include "convert32.cuh"
#include "emit_scan.cuh"
#include "horner.cuh"
#include "pow32.cuh"
#include "scan.cuh"
using namespace msm;

// canonical 13-bit limbs <-> words
static void ld(fe32& x, const int32_t* a) {
  uint32_t v[L];
  for (int i = 0; i < L; ++i) v[i] = (uint32_t)a[i];
  fe32_from_limbs(x, v);
}
static void st(int32_t* o, const fe32& x) {
  uint32_t v[L];
  fe32_to_limbs(v, x);
  for (int i = 0; i < L; ++i) o[i] = (int32_t)v[i];
}
static void ld_pt(pt32& p, const int32_t* a) {
  pt32_load_balanced(p, a, a + L, a + 2 * L);
}
static void st_pt(int32_t* o, const pt32& p) {
  st(o, p.x);
  st(o + L, p.y);
  st(o + 2 * L, p.z);
}

extern "C" {
void w_mul(const int32_t* a, const int32_t* b, int32_t* o, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    fe32 x, y, r;
    ld(x, a + i * L);
    ld(y, b + i * L);
    fe32_mul(r, x, y);
    st(o + i * L, r);
  }
}
void w_sqr_sym(const int32_t* a, int32_t* o, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    fe32 x, r;
    ld(x, a + i * L);
    fe32_sqr_sym(r, x);
    st(o + i * L, r);
  }
}
// kernel 9's body: a [B, L, R] balanced, o [B, L, R]; e: exponent words,
// least significant first; the table at stride 1 (the card's is [entry]
// [word][thread] in shared memory)
void w_pow(const int32_t* a, int32_t* o, const uint32_t* e, int nbits,
           int64_t B, int R) {
  uint32_t tab[POW_TABLE * NW];
  for (int64_t b = 0; b < B; ++b)
    for (int r = 0; r < R; ++r) {
      int32_t v[L];
      for (int i = 0; i < L; ++i) v[i] = a[b * L * R + r + i * (int64_t)R];
      fe32 x, y;
      fe32_from_balanced(x, v);
      pow32_window(y, x, e, nbits, tab, 1);
      fe32_store_limbs_strided(o + b * L * R + r, R, y);
    }
}
void w_pair_suffix(const int32_t* packed, const int32_t* perm,
                   const int32_t* flags, int32_t* s, int64_t G, int Cp,
                   int R) {
  for (int64_t g = 0; g < G; ++g)
    for (int r = 0; r < R; ++r)
      pair_chain32_lane<2, false>(packed, perm, flags, s, g, Cp, R, r);
}
// o [n, 5, L]: a + b, a - b, -a, 2a, 3b a
void w_linear(const int32_t* a, const int32_t* b, int32_t* o, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    fe32 x, y, r[5];
    ld(x, a + i * L);
    ld(y, b + i * L);
    fe32_add(r[0], x, y);
    fe32_sub(r[1], x, y);
    fe32_neg(r[2], x);
    fe32_double(r[3], x);
    fe32_mul_small<B3>(r[4], x);
    for (int k = 0; k < 5; ++k) st(o + (i * 5 + k) * L, r[k]);
  }
}
// canonical limbs -> words [n, NW] -> limbs [n, L]
void w_repack(const int32_t* a, int32_t* words, int32_t* o, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    fe32 x;
    ld(x, a + i * L);
    for (int k = 0; k < NW; ++k) words[i * NW + k] = (int32_t)x.w[k];
    st(o + i * L, x);
  }
}
// packed rows [n, 2 NW] -> limbs [n, 2, L]
void w_load_rows(const int32_t* packed, int32_t* o, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    fe32 x, y;
    scan_load_element<2>(x, y, packed, i, nullptr);
    st(o + i * 2 * L, x);
    st(o + i * 2 * L + L, y);
  }
}
// element i: row perm[i] of the GLV table [N, 3 NW], flags[i] -> limbs
// [n, 2, L]
void w_load_elements_glv(const int32_t* packed, const int32_t* perm,
                         const int32_t* flags, int32_t* o, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    fe32 x, y;
    scan_load_element<3>(x, y, packed, perm[i], flags + i);
    st(o + i * 2 * L, x);
    st(o + i * 2 * L + L, y);
  }
}
void w_from_balanced(const int32_t* a, int32_t* o, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    fe32 r;
    fe32_from_balanced(r, a + i * L);
    st(o + i * L, r);
  }
}
void w_pt_add(const int32_t* p, const int32_t* q, int32_t* o, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    pt32 a, b, r;
    ld_pt(a, p + i * 3 * L);
    ld_pt(b, q + i * 3 * L);
    pt32_add(r, a, b);
    st_pt(o + i * 3 * L, r);
  }
}
void w_pt_madd(const int32_t* p, const int32_t* xy, int32_t* o, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    pt32 a, r;
    fe32 x, y;
    ld_pt(a, p + i * 3 * L);
    ld(x, xy + i * 2 * L);
    ld(y, xy + i * 2 * L + L);
    pt32_madd(r, a, x, y);
    st_pt(o + i * 3 * L, r);
  }
}
void w_pt_double(const int32_t* p, int32_t* o, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    pt32 a, r;
    ld_pt(a, p + i * 3 * L);
    pt32_double(r, a);
    st_pt(o + i * 3 * L, r);
  }
}
void w_scan(const int32_t* packed, const int32_t* perm, const int32_t* flags,
            int32_t* pe3, int32_t* tx, int32_t* ty, int32_t* tz, int64_t G,
            int C, int R) {
  for (int64_t g = 0; g < G; ++g)
    for (int r = 0; r < R; ++r)
      scan_lane(packed, perm, flags, pe3, tx, ty, tz, g, C, R, r);
}
void w_scan_glv(const int32_t* packed, const int32_t* perm,
                const int32_t* flags, int32_t* pe3, int32_t* tx, int32_t* ty,
                int32_t* tz, int64_t G, int C, int R) {
  for (int64_t g = 0; g < G; ++g)
    for (int r = 0; r < R; ++r)
      scan_lane<3>(packed, perm, flags, pe3, tx, ty, tz, g, C, R, r);
}
void w_pair_suffix_glv(const int32_t* packed, const int32_t* perm,
                       const int32_t* flags, int32_t* s, int64_t G, int Cp,
                       int R) {
  for (int64_t g = 0; g < G; ++g)
    for (int r = 0; r < R; ++r)
      pair_chain32_lane<3, false>(packed, perm, flags, s, g, Cp, R, r);
}
void w_emit_scan_glv(const int32_t* packed, const int32_t* perm,
                     const int32_t* flags, const int32_t* s, const int32_t* t0,
                     int32_t* pe3, int32_t* tx, int32_t* ty, int32_t* tz,
                     int64_t G, int Cp, int R) {
  for (int64_t g = 0; g < G; ++g)
    for (int r = 0; r < R; ++r)
      emit_scan_lane<3>(packed, perm, flags, s, t0, pe3, tx, ty, tz, g, Cp, R,
                        r);
}
void w_convert(const int16_t* xw, const int16_t* yw, int32_t* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) convert_point(xw, yw, out, i);
}
void w_convert_glv(const int16_t* xw, const int16_t* yw, int32_t* out,
                   int64_t n) {
  for (int64_t i = 0; i < n; ++i) convert_point_glv(xw, yw, out, i);
}
// the x constants as NW words each; layout CONVERT_ONE, _DUAL or _TRIPLE
void w_convert_scaled(const int16_t* xw, const int16_t* yw,
                      const uint32_t* xs, const uint32_t* xs2, int32_t* out,
                      int32_t* out2, int64_t n, int layout) {
  fe32 a, b;
  for (int k = 0; k < NW; ++k) {
    a.w[k] = xs[k];
    b.w[k] = xs2[k];
  }
  for (int64_t i = 0; i < n; ++i) {
    if (layout == CONVERT_ONE)
      convert_point_scaled<CONVERT_ONE>(xw, yw, a, b, out, out2, i);
    else if (layout == CONVERT_DUAL)
      convert_point_scaled<CONVERT_DUAL>(xw, yw, a, b, out, out2, i);
    else
      convert_point_scaled<CONVERT_TRIPLE>(xw, yw, a, b, out, out2, i);
  }
}
// kernels 10 and 11's bodies over a table of `coords` coordinates a row
void w_pair_forward(const int32_t* packed, const int32_t* perm,
                    const int32_t* flags, int32_t* m, int64_t G, int Cp, int R,
                    int coords) {
  for (int64_t g = 0; g < G; ++g)
    for (int r = 0; r < R; ++r) {
      if (coords == 3)
        pair_chain32_lane<3, true>(packed, perm, flags, m, g, Cp, R, r);
      else
        pair_chain32_lane<2, true>(packed, perm, flags, m, g, Cp, R, r);
    }
}
void w_pair_backward(const int32_t* packed, const int32_t* perm,
                     const int32_t* flags, const int32_t* m,
                     const int32_t* minv, int32_t* cx, int32_t* cy,
                     int32_t* inf, int64_t G, int Cp, int R, int coords) {
  for (int64_t g = 0; g < G; ++g)
    for (int r = 0; r < R; ++r) {
      if (coords == 3)
        pair_backward32_lane<3>(packed, perm, flags, m, minv, cx, cy, inf, g,
                                Cp, R, r);
      else
        pair_backward32_lane<2>(packed, perm, flags, m, minv, cx, cy, inf, g,
                                Cp, R, r);
    }
}
void w_emit_scan(const int32_t* packed, const int32_t* perm,
                 const int32_t* flags, const int32_t* s, const int32_t* t0,
                 int32_t* pe3, int32_t* tx, int32_t* ty, int32_t* tz,
                 int64_t G, int Cp, int R) {
  for (int64_t g = 0; g < G; ++g)
    for (int r = 0; r < R; ++r)
      emit_scan_lane(packed, perm, flags, s, t0, pe3, tx, ty, tz, g, Cp, R, r);
}
// kernel 8's chain body for every (subtask, chain): b* [G, Bl, T, L]
// balanced, m*, g* [G, T, L]; the group's two halves (the m chain and the
// acc chain a step behind) run step by step, the level products that each
// half splits computed here by one thread
void w_bpr_phase1(const int32_t* bx, const int32_t* by, const int32_t* bz,
                  int32_t* mx, int32_t* my, int32_t* mz, int32_t* gx,
                  int32_t* gy, int32_t* gz, int64_t G, int Bl, int T) {
  for (int64_t g = 0; g < G; ++g)
    for (int t = 0; t < T; ++t)
      bpr_phase1_chain<4>(bx, by, bz, mx, my, mz, gx, gy, gz, g, Bl, T, t,
                          true);
}
// the chain of per-level products (the lanes' split, computed here by one
// thread)
void w_horner(const int32_t* wx, const int32_t* wy, const int32_t* wz,
              int32_t* ox, int32_t* oy, int32_t* oz, int S, int chunk) {
  std::vector<pt32> w(S);
  for (int s = 0; s < S; ++s) horner_load(w[s], wx, wy, wz, s);
  pt32 acc;
  horner_chain(acc, w.data(), S, chunk);
  pt32_store_limbs(ox, oy, oz, 1, acc);
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available")
    d = tmp_path_factory.mktemp("fe32_host")
    src = d / "harness.cpp"
    src.write_text(HARNESS)
    so = d / "harness.so"
    subprocess.run(
        [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", *FIELD_FLAGS, f"-I{CSRC}", "-o", str(so), str(src)],
        check=True, capture_output=True, text=True, timeout=600,
    )
    lib = ctypes.CDLL(str(so))
    Pt, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for name, argtypes in (("w_mul", [Pt] * 3 + [I64]), ("w_sqr_sym", [Pt] * 2 + [I64]),
                           ("w_pow", [Pt] * 3 + [I32, I64, I32]),
                           ("w_pair_suffix", [Pt] * 4 + [I64, I32, I32]),
                           ("w_linear", [Pt] * 3 + [I64]),
                           ("w_repack", [Pt] * 3 + [I64]), ("w_load_rows", [Pt] * 2 + [I64]),
                           ("w_load_elements_glv", [Pt] * 4 + [I64]),
                           ("w_scan_glv", [Pt] * 7 + [I64, I32, I32]),
                           ("w_pair_suffix_glv", [Pt] * 4 + [I64, I32, I32]),
                           ("w_emit_scan_glv", [Pt] * 9 + [I64, I32, I32]),
                           ("w_convert_glv", [Pt] * 3 + [I64]),
                           ("w_convert_scaled", [Pt] * 6 + [I64, I32]),
                           ("w_pair_forward", [Pt] * 4 + [I64, I32, I32, I32]),
                           ("w_pair_backward", [Pt] * 8 + [I64, I32, I32, I32]),
                           ("w_from_balanced", [Pt] * 2 + [I64]), ("w_pt_add", [Pt] * 3 + [I64]),
                           ("w_pt_madd", [Pt] * 3 + [I64]), ("w_pt_double", [Pt] * 2 + [I64]),
                           ("w_scan", [Pt] * 7 + [I64, I32, I32]),
                           ("w_convert", [Pt] * 3 + [I64]),
                           ("w_emit_scan", [Pt] * 9 + [I64, I32, I32]),
                           ("w_horner", [Pt] * 6 + [I32, I32]),
                           ("w_bpr_phase1", [Pt] * 9 + [I64, I32, I32])):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None
    return lib


def _run(lib, name, outs, *args):
    """Call a harness function on numpy int32 inputs and freshly zeroed
    outputs of the given shapes; ints pass as they are, after the arrays."""
    arrays = [np.ascontiguousarray(a, dtype=np.int32) for a in args if isinstance(a, np.ndarray)]
    ints = [a for a in args if not isinstance(a, np.ndarray)]
    out = [np.zeros(shape, dtype=np.int32) for shape in outs]
    getattr(lib, name)(*(a.ctypes.data for a in arrays), *(o.ctypes.data for o in out), *ints)
    return out


def _assert_canonical_equal(got, twin):
    """got: canonical limbs from the core; twin: any representation (torch)."""
    assert got.min() >= 0 and got.max() < (1 << CFG.word_size)
    assert np.array_equal(got, F.canonical(twin).numpy())


def _limbs(vals) -> np.ndarray:
    """python ints in [0, 2^260) -> [n, L] 13-bit limbs (not Montgomery)."""
    return ints_to_limbs(list(vals), CFG.word_size, L).astype(np.int32)


def _redc_edges(n: int, seed: int) -> tuple[list[int], list[int]]:
    """Pairs (a, b) < p at the word product's edges: the largest first REDC
    results t = (a b + M p) / 2^256 (M = -a b p^-1 mod 2^256) among values
    near p, ones with t >= p, and ones where the 4-bit step leaves a value
    >= p, so both conditional subtracts are taken and skipped."""
    rng = random.Random(seed)
    ninv = -pow(P, -1, 1 << 256) % (1 << 256)
    found = []
    for _ in range(4000):
        a, b = P - 1 - rng.getrandbits(250), P - 1 - rng.getrandbits(rng.choice((8, 128, 250)))
        t = (a * b + (a * b * ninv % (1 << 256)) * P) >> 256
        t2 = (t + ((t * 9) % 16) * P) >> 4
        found.append((t, t2 >= P, a, b))
    found.sort(reverse=True)
    top = found[: n // 2]
    over = [f for f in found[n // 2:] if f[1]][: n // 2]
    assert top[0][0] >= P and over, "edge search found no value above p"
    pairs = top + over
    return [a for _, _, a, _ in pairs], [b for _, _, _, b in pairs]


def test_mont_mul_random_and_edges(lib):
    rng = np.random.default_rng(31)
    a, b = rand_canonical(rng, (256,), CFG), rand_canonical(rng, (256,), CFG)
    r_mod_p = CFG.r % P
    edges = [0, 1, P - 1, r_mod_p, P - r_mod_p, (1 << 253) - 1, 1 << 253]
    ea, eb = zip(*[(x, y) for x in edges for y in edges])
    ra, rb = _redc_edges(64, seed=32)
    a = np.concatenate([a, _limbs(ea), _limbs(ra)])
    b = np.concatenate([b, _limbs(eb), _limbs(rb)])
    (got,) = _run(lib, "w_mul", [a.shape], a, b, a.shape[0])
    _assert_canonical_equal(got, F.mont_mul(torch.from_numpy(a), torch.from_numpy(b)))


def test_dedicated_square_random_and_edges(lib):
    """fe32_sqr_sym (kernel 9's squaring) against the twin's a a on random
    values, the edges of the product test squared, and values near p whose
    REDC result lands at or above p."""
    rng = np.random.default_rng(51)
    a = rand_canonical(rng, (256,), CFG)
    r_mod_p = CFG.r % P
    edges = [0, 1, 2, P - 1, P - 2, r_mod_p, P - r_mod_p, (1 << 253) - 1, 1 << 253, (1 << 32) - 1]
    ninv = -pow(P, -1, 1 << 256) % (1 << 256)
    near = [P - 1 - random.Random(52 + i).getrandbits(k) for i, k in enumerate([4, 64, 128, 200, 250] * 40)]
    high = sorted(near, key=lambda v: -((v * v + (v * v * ninv % (1 << 256)) * P) >> 256))[:64]
    a = np.concatenate([a, _limbs(edges), _limbs(high)])
    (got,) = _run(lib, "w_sqr_sym", [a.shape], a, a.shape[0])
    ta = torch.from_numpy(a)
    _assert_canonical_equal(got, F.mont_mul(ta, ta))


def _exp_words(e: int):
    nw = max(1, (e.bit_length() + 31) // 32)
    return (ctypes.c_uint32 * nw)(*((e >> (32 * i)) & 0xFFFFFFFF for i in range(nw)))


@pytest.mark.parametrize("e", [0, 1, 2, P - 2, "random1000"])
def test_pow_window_matches_twin(lib, e):
    """Kernel 9's body (the fixed 4-bit window over fe32_sqr_sym) against
    mont_pow_plain on a = 0, one, p - 1 (Montgomery), balanced limbs with
    negative entries and random canonical values, [B, L, R] limbs-first,
    for e = 0 (one), 1, 2, p - 2 (the inverse) and a random 1000-bit e."""
    if e == "random1000":
        e = random.Random(53).getrandbits(1000) | (1 << 999)
    rng = np.random.default_rng(54)
    B, R = 2, 8
    a = np.concatenate([mont_limbs([0, 1, P - 1], CFG), rand_balanced(rng, (7,), CFG),
                        rand_canonical(rng, (6,), CFG)])
    a[3:7] = -a[3:7]  # negative values
    a = np.ascontiguousarray(a.reshape(B, R, L).transpose(0, 2, 1))
    assert (a < 0).any()
    words = _exp_words(e)
    (got,) = _run(lib, "w_pow", [a.shape], a, ctypes.addressof(words), e.bit_length(), B, R)
    want = mont_pow_plain(CFG, torch.from_numpy(a), e)
    _assert_canonical_equal(np.ascontiguousarray(got.swapaxes(-1, -2)), want.transpose(-1, -2))
    if e >= 1:  # 0^e = 0
        assert not got[0, :, 0].any()


@pytest.mark.parametrize("G, Cp, R", [(2, 4, 16), (1, 1, 8), (3, 5, 4)])
def test_pair_suffix_lanes_match_twin(lib, G, Cp, R):
    """Kernel 12's per-lane body (pair32.cuh: the gathers pipelined a pair
    ahead) for every lane of a stream of real points with doubling and
    infinity pairs, against pair_suffix_plain: lane 0 of subtask 0 starts
    with P + (-P) and lane 1 with P + P, and lanes 2 and 3 hold the same
    at the last pair, where the backward walk starts."""
    _, packed, perm, flags = pair_stream(CFG, G, 2 * Cp, R, nbase=8, seed=55 + Cp)
    last = 2 * (Cp - 1)
    for lane, j in ((0, 0), (1, 0), (2, last), (3, last)):
        perm[0, j + 1, lane] = perm[0, j, lane]
        flags[0, j + 1, lane] = flags[0, j, lane] ^ (lane % 2 == 0)  # even lanes: P + (-P)
    (s,) = _run(lib, "w_pair_suffix", [(G, Cp, L, R)], packed, perm, flags, G, Cp, R)
    want = pair_suffix_plain(CFG, *(torch.from_numpy(np.ascontiguousarray(a)) for a in (packed, perm, flags)))
    _assert_canonical_equal(np.ascontiguousarray(s.swapaxes(-1, -2)), want.transpose(-1, -2))
    dbl, inf = (k.numpy() for k in _pair_predicates(packed, perm, flags))
    assert dbl[0, 0, 1] and inf[0, 0, 0] and dbl[0, -1, 3] and inf[0, -1, 2]


def _pair_predicates(packed, perm, flags):
    """(dbl, inf) [G, Cp, R] of a pair stream, by the twins' predicates."""
    from msm_tpu_torch.ops.cuda_compress import pair_predicates_plain
    from msm_tpu_torch.ops.cuda_convert import coord_words, unpack_coords

    D = coord_words(CFG)
    rows = torch.from_numpy(packed)[torch.from_numpy(perm).long()]
    x, y = unpack_coords(rows[..., :D], CFG), unpack_coords(rows[..., D:], CFG)
    sg = torch.from_numpy(flags) & 1
    return pair_predicates_plain(CFG, x[:, 0::2], y[:, 0::2], sg[:, 0::2], x[:, 1::2], y[:, 1::2], sg[:, 1::2])


def test_add_sub_neg_double_and_3b_multiple(lib):
    rng = np.random.default_rng(33)
    a, b = rand_canonical(rng, (200,), CFG), rand_canonical(rng, (200,), CFG)
    a[:4] = _limbs([0, 0, P - 1, P - 1])
    b[:4] = _limbs([0, P - 1, 1, P - 1])
    b[4:8] = a[4:8]  # a - a = 0
    (got,) = _run(lib, "w_linear", [(200, 5, L)], a, b, 200)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    b3m = torch.from_numpy(b3_mont_limbs(CFG))
    want = (F.add(ta, tb), F.sub(ta, tb), F.neg(ta), F.double(ta), F.mont_mul(ta, b3m))
    for k, w in enumerate(want):
        _assert_canonical_equal(got[:, k], w)


def test_repack_round_trip_and_dense_rows(lib):
    """13-bit limbs -> words is the packed table's dense form
    (pack_canonical), words -> limbs gives the limbs back, and a packed row
    loads as its two coordinates."""
    rng = np.random.default_rng(34)
    a = rand_canonical(rng, (300,), CFG)
    a[:3] = _limbs([0, P - 1, (1 << 254) - 1])  # top word of a 254-bit value
    words, back = _run(lib, "w_repack", [(300, 8), a.shape], a, 300)
    assert np.array_equal(words, pack_canonical(torch.from_numpy(a), CFG).numpy())
    assert np.array_equal(back, a)
    packed = np.concatenate([words[:150], words[150:]], axis=1)  # rows x || y
    (xy,) = _run(lib, "w_load_rows", [(150, 2, L)], packed, 150)
    assert np.array_equal(xy[:, 0], a[:150]) and np.array_equal(xy[:, 1], a[150:])


def test_from_balanced(lib):
    """Balanced limbs, negated values, values below -R and limbs spread
    beyond 13 bits, as kernel 7's inputs may be."""
    rng = np.random.default_rng(35)
    x = rand_balanced(rng, (300,), CFG)
    x[:80] = -x[:80]
    x[80:100, -1] -= 1 << CFG.word_size
    x[100:110, -1] += (1 << CFG.word_size) - 40
    x[110:120] = 0
    x[120:130] = _limbs([P] * 10)
    got = _run(lib, "w_from_balanced", [x.shape], x, 300)[0]
    _assert_canonical_equal(got, torch.from_numpy(x))


def _rand_points(rng, n):
    """Random coordinates (any field elements: the formulas are algebraic),
    balanced, plus the identity."""
    pts = np.stack([rand_balanced(rng, (n,), CFG) for _ in range(3)], axis=1)
    pts[0, 0], pts[0, 1], pts[0, 2] = 0, F.r_limbs, 0
    return pts


def test_rcb16_add(lib):
    """Algorithm 7, with P + P and P + (-P) rows."""
    rng = np.random.default_rng(36)
    p, q = _rand_points(rng, 64), _rand_points(rng, 64)
    q[1] = p[1]
    q[2, 0], q[2, 1], q[2, 2] = p[2, 0], -p[2, 1], p[2, 2]
    (got,) = _run(lib, "w_pt_add", [(64, 3, L)], p, q, 64)
    tp, tq = torch.from_numpy(p), torch.from_numpy(q)
    want = point_add_plain(CFG, tp[:, 0], tp[:, 1], tp[:, 2], tq[:, 0], tq[:, 1], tq[:, 2])
    for i in range(3):
        _assert_canonical_equal(got[:, i], want[i])


def test_rcb16_madd_and_double(lib):
    """Algorithms 8 and 9."""
    rng = np.random.default_rng(37)
    p = _rand_points(rng, 64)
    xy = np.stack([rand_canonical(rng, (64,), CFG) for _ in range(2)], axis=1)
    (got,) = _run(lib, "w_pt_madd", [(64, 3, L)], p, xy, 64)
    tp, txy = torch.from_numpy(p), torch.from_numpy(xy)
    b3m = torch.from_numpy(b3_mont_limbs(CFG))
    want = rcb16_madd_plain(F, b3m, tp[:, 0], tp[:, 1], tp[:, 2], txy[:, 0], txy[:, 1])
    for i in range(3):
        _assert_canonical_equal(got[:, i], want[i])
    (got,) = _run(lib, "w_pt_double", [(64, 3, L)], p, 64)
    want = CurveCtx(CFG).double(PointBatch(tp[:, 0], tp[:, 1], tp[:, 2]))
    for i in range(3):
        _assert_canonical_equal(got[:, i], want[i])


@pytest.mark.parametrize("G, C, R", [(1, 4, 64), (2, 3, 16), (1, 1, 8)])
def test_scan_lanes_match_twin(lib, G, C, R):
    """Kernel 4's per-lane body for every lane of a stream of real points
    with random signs (and rows repeated: P + P and P + (-P) steps), against
    scan_rows_plain: every pe3 row and lane total."""
    _, packed, perm, flags = pair_stream(CFG, G, C + C % 2, R, nbase=12, seed=38 + C)
    perm, flags = perm[:, :C], flags[:, :C]
    got = _run(lib, "w_scan", [(G, C, R, 3 * L)] + [(G, L, R)] * 3,
               packed, perm, flags, G, C, R)
    want = scan_rows_plain(CFG, *(torch.from_numpy(np.ascontiguousarray(a)) for a in (packed, perm, flags)))
    for i in range(3):  # pe3 rows: x || y || z
        _assert_canonical_equal(got[0][..., i * L:(i + 1) * L], want[0][..., i * L:(i + 1) * L])
    for g, w in zip(got[1:], want[1:]):
        _assert_canonical_equal(np.ascontiguousarray(g.swapaxes(-1, -2)), w.transpose(-1, -2))


@pytest.mark.parametrize("S, chunk", [(4, 4), (16, 16), (20, 13), (3, 1), (1, 5), (2, 15), (2, 12)])
def test_horner_chain_matches_twin(lib, S, chunk):
    """Kernel 7's load and chain of per-level products (the products the
    lanes of a warp split) on balanced window sums (some negated, one the
    identity) against horner_plain, at the 2^20 and 2^16 MSMs' shapes, a
    small one, a single window, and the two-point folds of the 2^20 and
    2^16 window sums (window_sum_from_pe at c = 16 and 13)."""
    rng = np.random.default_rng(39 + S)
    w = [rand_balanced(rng, (S,), CFG) for _ in range(3)]
    w[1][::3] *= -1
    w[0][S // 2], w[1][S // 2], w[2][S // 2] = 0, mont_limbs([1], CFG)[0], 0
    got = _run(lib, "w_horner", [(L,)] * 3, *w, S, chunk)
    want = horner_plain(CFG, *map(torch.from_numpy, w), chunk)
    for g, t in zip(got, want):
        _assert_canonical_equal(g, t)


@pytest.mark.parametrize("G, Bl, T", [(2, 4, 8), (1, 1, 4), (3, 8, 2)])
def test_bpr_phase1_lanes_match_twin(lib, G, Bl, T):
    """Kernel 8's chain body for every (subtask, chain) on balanced inputs
    against the twin. The host runs the kernel's schedule step by step: the
    group's two halves, the m chain and the acc chain a step behind, with
    the device's operand selects and discard predicates over its Bl + 1
    steps (only the shuffle that hands m over and the lane's half are the
    device's own). Planted: negated rows, an identity bucket at the second
    step (there acc + m adds a point to itself), and a chain whose second
    bucket equals its first, its running sum (there m + B adds a point to
    itself). The same additions in the same order, so m and g agree after
    canonical() on field triples off the curve too."""
    rng = np.random.default_rng(27 + Bl)
    b = [rand_balanced(rng, (G, Bl, T), CFG) for _ in range(3)]
    b[1][0, :, ::2] *= -1
    one = mont_limbs([1], CFG)[0]
    top = max(Bl - 2, 0)
    b[0][-1, top, T - 1], b[1][-1, top, T - 1], b[2][-1, top, T - 1] = 0, one, 0
    if Bl > 1:  # step Bl - 2 of chain 0 adds m = B[Bl - 1] to itself
        for c in b:
            c[0, Bl - 2, 0] = c[0, Bl - 1, 0]
    want = bpr_phase1_plain(CFG, *map(torch.from_numpy, b))
    got = _run(lib, "w_bpr_phase1", [(G, T, L)] * 6, *b, G, Bl, T)
    for g, w in zip(got, want):
        _assert_canonical_equal(g, w)


def _u16_words(vals) -> np.ndarray:
    """python ints in [0, 2^256) -> [n, 16] little-endian u16 words held in
    int16, as the host serializes coordinates."""
    buf = b"".join(v.to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u2").reshape(len(vals), 16).view(np.int16).copy()


def test_convert_point_matches_twin(lib):
    """Kernel 2's body on seeded coordinates below p and on unvalidated
    ones in [p, 2^256) (p, 2p - 1, 4p, 5p, 2^256 - 1, random), and 0,
    against convert_pack_plain: the packed table's dense words exactly."""
    rng = random.Random(41)
    edge = [0, 1, P - 1, P, P + 1, 2 * P - 1, 2 * P, 4 * P - 1, 4 * P, 5 * P, (1 << 256) - 1]
    xs = edge + [rng.randrange(P) for _ in range(100)] + [rng.randrange(P, 1 << 256) for _ in range(60)]
    ys = list(reversed(xs))
    xw, yw = _u16_words(xs), _u16_words(ys)
    n = len(xs)
    out = np.zeros((n, 16), dtype=np.int32)
    lib.w_convert(xw.ctypes.data, yw.ctypes.data, out.ctypes.data, n)
    want = convert_pack_plain(CFG, torch.from_numpy(xw), torch.from_numpy(yw)).numpy()
    assert np.array_equal(out, want)
    # the table holds x R mod p and y R mod p
    got_x = [int.from_bytes(out[i, :8].astype("<u4").tobytes(), "little") for i in range(n)]
    assert got_x == [x * CFG.r % P for x in xs]


@pytest.mark.parametrize("G, Cp, R", [(2, 4, 16), (1, 1, 8), (3, 2, 4)])
def test_emit_scan_lanes_match_twin(lib, G, Cp, R):
    """Kernel 13's per-lane body for every lane of a stream of real points
    with planted doubling and infinity pairs (lane 0 of subtask 0 starts
    with an infinity pair, lane 1 with a doubling), on the twins' suffix
    products (canonical) and Fermat inverse t0 (balanced), against
    emit_scan_plain: every pe3 row and lane total."""
    _, packed, perm, flags = pair_stream(CFG, G, 2 * Cp, R, nbase=8, seed=42 + Cp)
    perm[0, 1, :2] = perm[0, 0, :2]
    flags[0, 1, 0] = flags[0, 0, 0] ^ 1  # P + (-P)
    flags[0, 1, 1] = flags[0, 0, 1]  # P + P
    tp, tm, tf = (torch.from_numpy(np.ascontiguousarray(a)) for a in (packed, perm, flags))
    s = F.canonical(pair_suffix_plain(CFG, tp, tm, tf).transpose(-1, -2)).transpose(-1, -2).contiguous()
    t0 = mont_pow_plain(CFG, s[:, 0], P - 2)
    got = _run(lib, "w_emit_scan", [(G, Cp, R, 3 * L)] + [(G, L, R)] * 3,
               packed, perm, flags, s.numpy(), t0.numpy(), G, Cp, R)
    want = emit_scan_plain(CFG, tp, tm, tf, s, t0)
    for i in range(3):  # pe3 rows: x || y || z
        _assert_canonical_equal(got[0][..., i * L:(i + 1) * L], want[0][..., i * L:(i + 1) * L])
    for g, w in zip(got[1:], want[1:]):
        _assert_canonical_equal(np.ascontiguousarray(g.swapaxes(-1, -2)), w.transpose(-1, -2))
    # lane 0 starts with P + (-P): its first prefix is the identity
    assert not F.canonical(want[0][0, 0, 0, 2 * L:]).any()


# -- the GLV modes: three-coordinate rows, x or beta x by flag bit 1 ----------


def _glv_stream(G, C, R, seed):
    """glv_pair_stream over 16 table rows (8 points and their phi images) as
    numpy and as torch tensors."""
    _, packed, perm, flags = glv_pair_stream(GLV, G, C, R, nbase=16, seed=seed)
    return (packed, perm, flags), tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (packed, perm, flags))


def test_convert_point_glv_matches_twin(lib):
    """Kernel 2's GLV body on the coordinates of test_convert_point_matches_twin
    (values >= p included): rows x R, beta x R, y R exactly as the twin's."""
    from msm_tpu_torch.ops.glv import glv_params

    rng = random.Random(43)
    edge = [0, 1, P - 1, P, P + 1, 2 * P - 1, 4 * P, 5 * P, (1 << 256) - 1]
    xs = edge + [rng.randrange(P) for _ in range(80)] + [rng.randrange(P, 1 << 256) for _ in range(40)]
    ys = list(reversed(xs))
    xw, yw = _u16_words(xs), _u16_words(ys)
    n = len(xs)
    out = np.zeros((n, 24), dtype=np.int32)
    lib.w_convert_glv(xw.ctypes.data, yw.ctypes.data, out.ctypes.data, n)
    want = convert_pack_plain(GLV, torch.from_numpy(xw), torch.from_numpy(yw)).numpy()
    assert np.array_equal(out, want)
    beta = glv_params(BN254).beta
    got_bx = [int.from_bytes(out[i, 8:16].astype("<u4").tobytes(), "little") for i in range(n)]
    assert got_bx == [x * beta * CFG.r % P for x in xs]


def test_glv_element_loads(lib):
    """scan_load_element<3>: every flag value 0..3 on every row of a GLV
    table gives x (bit 1 clear) or beta x (bit 1 set) and y, whatever bit 0."""
    from msm_tpu_torch.ops.cuda_convert import unpack_coords
    from msm_tpu_torch.ops.cuda_scan import element_coords

    (packed, _, _), _ = _glv_stream(1, 2, 2, seed=60)
    perm = np.repeat(np.arange(16, dtype=np.int32), 4)
    flags = np.tile(np.arange(4, dtype=np.int32), 16)
    (got,) = _run(lib, "w_load_elements_glv", [(64, 2, L)], packed, perm, flags, 64)
    x, y = element_coords(GLV, torch.from_numpy(packed)[torch.from_numpy(perm).long()], torch.from_numpy(flags))
    assert np.array_equal(got[:, 0], unpack_coords(x, CFG).numpy())
    assert np.array_equal(got[:, 1], unpack_coords(y, CFG).numpy())
    assert np.array_equal(got[0::4, 0], got[1::4, 0]) and not np.array_equal(got[0::4, 0], got[2::4, 0])


@pytest.mark.parametrize("G, C, R", [(1, 4, 64), (2, 3, 16)])
def test_scan_glv_lanes_match_twin(lib, G, C, R):
    """Kernel 4's GLV body for every lane of a GLV stream against
    scan_rows_plain under the GLV config."""
    (packed, perm, flags), _ = _glv_stream(G, C + C % 2, R, seed=61 + C)
    perm, flags = np.ascontiguousarray(perm[:, :C]), np.ascontiguousarray(flags[:, :C])
    got = _run(lib, "w_scan_glv", [(G, C, R, 3 * L)] + [(G, L, R)] * 3, packed, perm, flags, G, C, R)
    want = scan_rows_plain(GLV, *(torch.from_numpy(a) for a in (packed, perm, flags)))
    for i in range(3):
        _assert_canonical_equal(got[0][..., i * L:(i + 1) * L], want[0][..., i * L:(i + 1) * L])
    for g, w in zip(got[1:], want[1:]):
        _assert_canonical_equal(np.ascontiguousarray(g.swapaxes(-1, -2)), w.transpose(-1, -2))


@pytest.mark.parametrize("G, Cp, R", [(2, 4, 16), (1, 3, 8)])
def test_pair_suffix_and_emit_scan_glv_lanes_match_twins(lib, G, Cp, R):
    """Kernels 12 and 13's GLV bodies for every lane of a GLV stream whose
    planted pairs include an element of P_i's phi copy beside one of the
    row phi(P_i) (equal x across halves: a doubling or an infinity pair
    that the predicates must see on the selected x and the third
    coordinate's y), against the twins under the GLV config."""
    from msm_tpu_torch.ops.cuda_compress import _pairs_plain

    (packed, perm, flags), tin = _glv_stream(G, 2 * Cp, R, seed=64 + Cp)
    # lane 0 of subtask 0: (P_0 phi, phi(P_0)) same sign at the first pair
    # and opposite signs at the last
    perm[0, 0, 0], flags[0, 0, 0], perm[0, 1, 0], flags[0, 1, 0] = 0, 2, 8, 0
    perm[0, -2, 0], flags[0, -2, 0], perm[0, -1, 0], flags[0, -1, 0] = 1, 3, 9, 0
    tin = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (packed, perm, flags))
    dbl, inf = (k.numpy() for k in _pairs_plain(GLV, *tin)[6:])
    assert dbl[0, 0, 0] and inf[0, -1, 0]
    (s,) = _run(lib, "w_pair_suffix_glv", [(G, Cp, L, R)], packed, perm, flags, G, Cp, R)
    want_s = pair_suffix_plain(GLV, *tin)
    _assert_canonical_equal(np.ascontiguousarray(s.swapaxes(-1, -2)), want_s.transpose(-1, -2))
    s_t = torch.from_numpy(s)
    t0 = mont_pow_plain(CFG, s_t[:, 0], P - 2)
    got = _run(lib, "w_emit_scan_glv", [(G, Cp, R, 3 * L)] + [(G, L, R)] * 3,
               packed, perm, flags, s, t0.numpy(), G, Cp, R)
    want = emit_scan_plain(GLV, *tin, s_t, t0)
    for i in range(3):
        _assert_canonical_equal(got[0][..., i * L:(i + 1) * L], want[0][..., i * L:(i + 1) * L])
    for g, w in zip(got[1:], want[1:]):
        _assert_canonical_equal(np.ascontiguousarray(g.swapaxes(-1, -2)), w.transpose(-1, -2))


# -- kernels 10 and 11 on the word core, and the convert's scaled modes -------


def _planted_stream(coords, G, Cp, R, seed):
    """A pair stream over a 2- or 3-coordinate table with planted pairs at
    the first pair (lanes 0, 1) and the last (lanes 2, 3), where the forward
    and backward walks start: under GLV, P_0's phi copy beside the row
    phi(P_0) with equal signs (a doubling) and P_1's with opposite signs (an
    infinity pair); else P + (-P) on even lanes and P + P on odd ones."""
    if coords == 3:
        (packed, perm, flags), _ = _glv_stream(G, 2 * Cp, R, seed=seed)
        for lane, j in ((0, 0), (1, 0), (2, 2 * (Cp - 1)), (3, 2 * (Cp - 1))):
            i, flip = lane % 2, lane % 2  # odd lanes: opposite signs
            perm[0, j, lane], flags[0, j, lane] = i, 2
            perm[0, j + 1, lane], flags[0, j + 1, lane] = 8 + i, flip
        return packed, perm, flags
    _, packed, perm, flags = pair_stream(CFG, G, 2 * Cp, R, nbase=8, seed=seed)
    for lane, j in ((0, 0), (1, 0), (2, 2 * (Cp - 1)), (3, 2 * (Cp - 1))):
        perm[0, j + 1, lane] = perm[0, j, lane]
        flags[0, j + 1, lane] = flags[0, j, lane] ^ (lane % 2 == 0)
    return packed, perm, flags


@pytest.mark.parametrize("coords, G, Cp, R", [(2, 2, 4, 16), (2, 1, 1, 8), (2, 3, 5, 4),
                                              (3, 2, 4, 16), (3, 1, 3, 8)])
def test_pair_forward_backward_lanes_match_twins(lib, coords, G, Cp, R):
    """Kernels 10 and 11's word-core bodies (pair32.cuh) at COORDS 2 and 3
    for every lane of a stream with doubling and infinity pairs planted
    where each walk starts (under GLV: equal x across the table's halves),
    against pair_forward_plain and pair_backward_plain: the running
    products, then the pair sums and flags from the body's own products
    and the Fermat inverse of the last in balanced limbs."""
    cfg = GLV if coords == 3 else CFG
    packed, perm, flags = _planted_stream(coords, G, Cp, R, seed=70 + 10 * coords + Cp)
    tin = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (packed, perm, flags))
    (m,) = _run(lib, "w_pair_forward", [(G, Cp, L, R)], packed, perm, flags, G, Cp, R, coords)
    want_m = pair_forward_plain(cfg, *tin)
    _assert_canonical_equal(np.ascontiguousarray(m.swapaxes(-1, -2)), want_m.transpose(-1, -2))
    m_t = torch.from_numpy(m)
    minv = mont_pow_plain(CFG, m_t[:, -1], P - 2)
    minv[:, 0] += 1 << CFG.word_size  # the same values in balanced limbs
    minv[:, 1] -= 1
    cx, cy, inf = _run(lib, "w_pair_backward", [(G, Cp, L, R)] * 2 + [(G, Cp, R)],
                       packed, perm, flags, m, minv.numpy(), G, Cp, R, coords)
    wx, wy, winf = pair_backward_plain(cfg, *tin, m_t, minv)
    for got, want in ((cx, wx), (cy, wy)):
        _assert_canonical_equal(np.ascontiguousarray(got.swapaxes(-1, -2)), want.transpose(-1, -2))
    assert np.array_equal(inf, winf.numpy())
    last = Cp - 1
    assert inf[0, 0, 0 if coords == 2 else 1] and inf[0, last, 2 if coords == 2 else 3]


def _words32(v: int) -> np.ndarray:
    return np.array([(v >> (32 * k)) & 0xFFFFFFFF for k in range(8)], dtype=np.uint32)


@pytest.mark.parametrize("mode", ["override", "default", "dual", "triple_override"])
def test_convert_point_scaled_matches_twin(lib, mode):
    """The convert kernel's run-time-constant body (convert_point_scaled) in
    each output layout, on the coordinates of test_convert_point_matches_twin
    (values >= p included), against convert_pack_scaled_plain: an x constant
    that overrides R^2, the default R^2 (the plain table), two tables
    sharing y, and the triple table with an overridden first constant."""
    from msm_tpu_torch.ops.cuda_convert import CONVERT_DUAL, CONVERT_ONE, CONVERT_TRIPLE
    from msm_tpu_torch.ops.glv import glv_params

    rng = random.Random(44)
    edge = [0, 1, P - 1, P, P + 1, 2 * P - 1, 4 * P, 5 * P, (1 << 256) - 1]
    xs = edge + [rng.randrange(P) for _ in range(60)] + [rng.randrange(P, 1 << 256) for _ in range(30)]
    ys = list(reversed(xs))
    xw, yw = _u16_words(xs), _u16_words(ys)
    n = len(xs)
    s1 = None if mode == "default" else rng.randrange(1, P) * CFG.r2 % P
    s2 = glv_params(BN254).beta * CFG.r2 % P if mode in ("dual", "triple_override") else None
    layout = {"dual": CONVERT_DUAL, "triple_override": CONVERT_TRIPLE}.get(mode, CONVERT_ONE)
    width = 24 if layout == CONVERT_TRIPLE else 16
    out, out2 = np.zeros((n, width), dtype=np.int32), np.zeros((n, 16), dtype=np.int32)
    c1, c2 = _words32(CFG.r2 % P if s1 is None else s1), _words32(s2 or 0)
    lib.w_convert_scaled(xw.ctypes.data, yw.ctypes.data, c1.ctypes.data, c2.ctypes.data,
                         out.ctypes.data, out2.ctypes.data, n, layout)
    want = convert_pack_scaled_plain(CFG, torch.from_numpy(xw), torch.from_numpy(yw), x_scale=s1,
                                     dual_x_scale=s2, triple=layout == CONVERT_TRIPLE)
    if layout == CONVERT_DUAL:
        assert np.array_equal(out, want[0].numpy()) and np.array_equal(out2, want[1].numpy())
    else:
        assert np.array_equal(out, want.numpy()) and not out2.any()
    got_x = [int.from_bytes(out[i, :8].astype("<u4").tobytes(), "little") for i in range(n)]
    scale = CFG.r2 if s1 is None else s1
    assert got_x == [x * scale * pow(CFG.r, -1, P) % P for x in xs]
    if mode == "default":
        assert np.array_equal(out, convert_pack_plain(CFG, torch.from_numpy(xw), torch.from_numpy(yw)).numpy())
