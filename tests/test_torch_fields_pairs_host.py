"""The compressed and GLV configs' per-thread kernel bodies on the generic
word core, compiled for the host with g++ (``_build.FIELD_FLAGS``) for all
seven fields and held against Python ints or the plain PyTorch twins of the
same curve: the Fermat inversion's window (kernel 9, pow32_window), the
pair algebra's predicates and denominators (pair32.cuh: fe32_sum_is_p,
pair32_make through the full-row load and through the x-only gather), the
suffix and forward products (kernels 12 and 10, pair_chain32_lane walking
either way), the backward emission (11, pair_backward32_lane), the fused
emission + scan (13, emit_scan_lane, its pe3 rows padded to a multiple of 4
limbs), each at COORDS 2 and 3 (the GLV table's rows x, beta x, y), and the
GLV loads of the convert (convert_point_glv, the field's beta R^2) and the
scan (scan_lane at COORDS 3). The pair streams hold doubling and infinity
pairs (x1 = x2 with y1 = y2 or y1 + y2 = p) and, under GLV, pairs of equal
x across the table's halves; secp256k1's sums that carry out of 2^256 and
Grumpkin's 3b = -51 (the emission's mixed add) are reached on their
curves."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_helpers import affine_points, glv_pair_stream, mont_limbs, pair_stream
from msm_tpu_torch.models.common import pad_points_words
from msm_tpu_torch.ops._build import FIELD_FLAGS, curve_id
from msm_tpu_torch.ops.cuda_compress import (_pairs_plain, emit_scan_plain, pair_backward_plain,
                                              pair_forward_plain, pair_suffix_plain)
from msm_tpu_torch.ops.cuda_convert import convert_pack_plain, coord_u16
from msm_tpu_torch.ops.cuda_inv import mont_pow_plain
from msm_tpu_torch.ops.cuda_scan import pe3_row_limbs, scan_rows_plain
from msm_tpu_torch.ops.field import get_field_ctx
from msm_tpu_torch.params import CURVES, MsmConfig, coord_words
from msm_tpu_torch.utils.limbs import limbs_to_int

CSRC = Path(__file__).resolve().parent.parent / "msm_tpu_torch" / "csrc"

HARNESS = r"""
#include <vector>

#include "convert32.cuh"
#include "emit_scan.cuh"
#include "pow32.cuh"
using namespace msm;

template <class F>
struct Pow {  // a, out [G, L, R]; the table at stride 1
  static void run(const int32_t* a, int32_t* out, const uint32_t* e, int nbits,
                  int64_t G, int R) {
    std::vector<uint32_t> tab(POW_TABLE * F::NW);
    for (int64_t g = 0; g < G; ++g)
      for (int r = 0; r < R; ++r) {
        const int64_t o = g * F::L * R + r;
        fe32t<F> x, y;
        fe32_load_balanced_strided(x, a + o, R);
        pow32_window(y, x, e, nbits, tab.data(), 1);
        fe32_store_limbs_strided(out + o, R, y);
      }
  }
};

template <class F>
struct SumIsP {  // a, b [n, NW] dense words -> out [n]
  static void run(const int32_t* a, const int32_t* b, int32_t* out, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
      fe32t<F> x, y;
      fe32_load_dense(x, a + i * F::NW);
      fe32_load_dense(y, b + i * F::NW);
      out[i] = fe32_sum_is_p(x, y);
    }
  }
};

// Every pair of a stream through both loads: d, dbl, inf from the full
// rows (pair32_load), d again from the x-only gather (pair32_gather_x);
// d* [G, Cp, L, R], dbl, inf [G, Cp, R].
template <class F, int C>
void denominators(const int32_t* packed, const int32_t* perm,
                  const int32_t* flags, int32_t* d1, int32_t* d2, int32_t* dbl,
                  int32_t* inf, int64_t G, int Cp, int R) {
  for (int64_t g = 0; g < G; ++g)
    for (int j = 0; j < Cp; ++j)
      for (int r = 0; r < R; ++r) {
        const int64_t e = (g * 2 * Cp + 2 * j) * R + r;
        const int64_t o = (g * Cp + j) * F::L * (int64_t)R + r;
        const int64_t f = (g * Cp + j) * (int64_t)R + r;
        pair32t<F> pr;
        pair32_load<C>(pr, packed, perm, flags, e, e + R);
        fe32t<F> d;
        pair32_denominator(d, pr);
        fe32_store_limbs_strided(d1 + o, R, d);
        dbl[f] = pr.dbl;
        inf[f] = pr.inf;
        pair32_xt<F> q;
        pair32_gather_x<C>(q, packed, perm, flags, e, e + R);
        pair32_denominator_x<C>(d, q, packed);
        fe32_store_limbs_strided(d2 + o, R, d);
      }
}

template <class F>
struct Denominators {
  static void run(const int32_t* packed, const int32_t* perm,
                  const int32_t* flags, int32_t* d1, int32_t* d2, int32_t* dbl,
                  int32_t* inf, int64_t G, int Cp, int R, int coords) {
    if (coords == 3)
      denominators<F, 3>(packed, perm, flags, d1, d2, dbl, inf, G, Cp, R);
    else
      denominators<F, 2>(packed, perm, flags, d1, d2, dbl, inf, G, Cp, R);
  }
};

template <class F>
struct Chain {  // kernel 10 (forward) or 12; out [G, Cp, L, R]
  static void run(const int32_t* packed, const int32_t* perm,
                  const int32_t* flags, int32_t* out, int64_t G, int Cp, int R,
                  int coords, int forward) {
    for (int64_t g = 0; g < G; ++g)
      for (int r = 0; r < R; ++r) {
        if (coords == 3 && forward)
          pair_chain32_lane<3, true, F>(packed, perm, flags, out, g, Cp, R, r);
        else if (coords == 3)
          pair_chain32_lane<3, false, F>(packed, perm, flags, out, g, Cp, R, r);
        else if (forward)
          pair_chain32_lane<2, true, F>(packed, perm, flags, out, g, Cp, R, r);
        else
          pair_chain32_lane<2, false, F>(packed, perm, flags, out, g, Cp, R, r);
      }
  }
};

template <class F>
struct Backward {  // kernel 11
  static void run(const int32_t* packed, const int32_t* perm,
                  const int32_t* flags, const int32_t* m, const int32_t* minv,
                  int32_t* cx, int32_t* cy, int32_t* inf, int64_t G, int Cp,
                  int R, int coords) {
    for (int64_t g = 0; g < G; ++g)
      for (int r = 0; r < R; ++r) {
        if (coords == 3)
          pair_backward32_lane<3, F>(packed, perm, flags, m, minv, cx, cy, inf,
                                     g, Cp, R, r);
        else
          pair_backward32_lane<2, F>(packed, perm, flags, m, minv, cx, cy, inf,
                                     g, Cp, R, r);
      }
  }
};

template <class F>
struct EmitScan {  // kernel 13; pe3 [G, Cp, R, pe3_row<F>]
  static void run(const int32_t* packed, const int32_t* perm,
                  const int32_t* flags, const int32_t* s, const int32_t* t0,
                  int32_t* pe3, int32_t* tx, int32_t* ty, int32_t* tz,
                  int64_t G, int Cp, int R, int coords) {
    for (int64_t g = 0; g < G; ++g)
      for (int r = 0; r < R; ++r) {
        if (coords == 3)
          emit_scan_lane<3, F>(packed, perm, flags, s, t0, pe3, tx, ty, tz, g,
                               Cp, R, r);
        else
          emit_scan_lane<2, F>(packed, perm, flags, s, t0, pe3, tx, ty, tz, g,
                               Cp, R, r);
      }
  }
};

template <class F>
struct ConvertGlv {  // xw, yw [n, 2 NW] int16 -> out [n, 3 NW]
  static void run(const int16_t* xw, const int16_t* yw, int32_t* out, int64_t n) {
    for (int64_t i = 0; i < n; ++i) convert_point_glv<F>(xw, yw, out, i);
  }
};

template <class F>
struct ScanGlv {  // kernel 4's GLV mode; pe3 [G, C, R, pe3_row<F>]
  static void run(const int32_t* packed, const int32_t* perm,
                  const int32_t* flags, int32_t* pe3, int32_t* tx, int32_t* ty,
                  int32_t* tz, int64_t G, int C, int R) {
    for (int64_t g = 0; g < G; ++g)
      for (int r = 0; r < R; ++r)
        scan_lane<3, F>(packed, perm, flags, pe3, tx, ty, tz, g, C, R, r);
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

typedef const int32_t* I;
typedef int32_t* O;
extern "C" {
void h_pow(int c, I a, const uint32_t* e, O out, int nbits, int64_t G, int R) {
  dispatch<Pow>(c, a, out, e, nbits, G, R);
}
void h_sum_is_p(int c, I a, I b, O out, int64_t n) { dispatch<SumIsP>(c, a, b, out, n); }
void h_denominators(int c, I packed, I perm, I flags, O d1, O d2, O dbl, O inf,
                    int64_t G, int Cp, int R, int coords) {
  dispatch<Denominators>(c, packed, perm, flags, d1, d2, dbl, inf, G, Cp, R, coords);
}
void h_chain(int c, I packed, I perm, I flags, O out, int64_t G, int Cp, int R,
             int coords, int forward) {
  dispatch<Chain>(c, packed, perm, flags, out, G, Cp, R, coords, forward);
}
void h_backward(int c, I packed, I perm, I flags, I m, I minv, O cx, O cy, O inf,
                int64_t G, int Cp, int R, int coords) {
  dispatch<Backward>(c, packed, perm, flags, m, minv, cx, cy, inf, G, Cp, R, coords);
}
void h_emit_scan(int c, I packed, I perm, I flags, I s, I t0, O pe3, O tx, O ty,
                 O tz, int64_t G, int Cp, int R, int coords) {
  dispatch<EmitScan>(c, packed, perm, flags, s, t0, pe3, tx, ty, tz, G, Cp, R, coords);
}
void h_convert_glv(int c, const int16_t* xw, const int16_t* yw, O out, int64_t n) {
  dispatch<ConvertGlv>(c, xw, yw, out, n);
}
void h_scan_glv(int c, I packed, I perm, I flags, O pe3, O tx, O ty, O tz,
                int64_t G, int C, int R) {
  dispatch<ScanGlv>(c, packed, perm, flags, pe3, tx, ty, tz, G, C, R);
}
}
"""

NAMES = list(CURVES)
P_, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
SIGNATURES = {
    "h_pow": [P_, P_, P_, I32, I64, I32],
    "h_sum_is_p": [P_] * 3 + [I64],
    "h_denominators": [P_] * 7 + [I64, I32, I32, I32],
    "h_chain": [P_] * 4 + [I64, I32, I32, I32, I32],
    "h_backward": [P_] * 8 + [I64, I32, I32, I32],
    "h_emit_scan": [P_] * 9 + [I64, I32, I32, I32],
    "h_convert_glv": [P_] * 3 + [I64],
    "h_scan_glv": [P_] * 7 + [I64, I32, I32],
}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available")
    d = tmp_path_factory.mktemp("fields_pairs_host")
    src, so = d / "harness.cpp", d / "harness.so"
    src.write_text(HARNESS)
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC", *FIELD_FLAGS, f"-I{CSRC}", "-o", str(so),
                    str(src)], check=True, capture_output=True, text=True, timeout=600)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = [I32] + argtypes
        fn.restype = None
    return lib


def _run(lib, name, cfg, out_shapes, *args):
    """Call h_<name> on the curve of cfg: numpy arrays pass as pointers
    (uint32 exponent words, int16 coordinate words or int32), then fresh
    int32 outputs of out_shapes, then the ints."""
    arrays = [np.ascontiguousarray(a) for a in args if isinstance(a, np.ndarray)]
    ints = [a for a in args if not isinstance(a, np.ndarray)]
    outs = [np.zeros(s, dtype=np.int32) for s in out_shapes]
    getattr(lib, name)(curve_id(cfg), *(a.ctypes.data for a in arrays), *(o.ctypes.data for o in outs), *ints)
    return outs


def _canonical(cfg, t) -> np.ndarray:
    return get_field_ctx(cfg).canonical(torch.as_tensor(t)).numpy()


def _assert_canonical_equal(cfg, got, want):
    """got: the body's canonical limbs; want: a twin's (any limbs)."""
    assert got.min() >= 0 and got.max() < (1 << cfg.word_size)
    assert np.array_equal(got, _canonical(cfg, want))


def _limbs_last(a: np.ndarray) -> np.ndarray:
    """[..., L, R] limbs-first lanes -> [..., R, L]."""
    return np.ascontiguousarray(a.swapaxes(-1, -2))


def _stream(cfg, coords: int, G: int, Cp: int, R: int, seed: int):
    """(packed, perm, flags) numpy: a pair stream over 16 real points of the
    curve (coords 2) or 8 points and their phi images (coords 3), with
    doubling and infinity pairs planted (_torch_helpers.pair_stream,
    glv_pair_stream), and P + P, P + (-P) planted where the forward and
    backward walks start (pairs 0 and Cp - 1 of lanes 0-3)."""
    if coords == 3:
        _, packed, perm, flags = glv_pair_stream(cfg, G, 2 * Cp, R, nbase=16, seed=seed)
    else:
        _, packed, perm, flags = pair_stream(cfg, G, 2 * Cp, R, nbase=16, seed=seed)
    for lane, j in ((0, 0), (1, 0), (2, 2 * (Cp - 1)), (3, 2 * (Cp - 1))):
        perm[0, j + 1, lane] = perm[0, j, lane]
        flags[0, j + 1, lane] = flags[0, j, lane] ^ (lane % 2 == 0)
    return packed, perm, flags


def _cfg(name: str, coords: int = 2) -> MsmConfig:
    return MsmConfig(curve=CURVES[name], glv=coords == 3)


@pytest.mark.parametrize("name", NAMES)
def test_pow_window_matches_python_ints(lib, name):
    """Kernel 9's window on every curve: lanes holding 0, 1, p - 1, random
    values and a negated (balanced) one, for e = 0, 1, 2, 15, 16, p - 2 and
    a 400-bit e, against pow() over Python ints in the Montgomery domain
    (pow(aR, e) = a^e R)."""
    cfg = _cfg(name)
    p, L, R, G = cfg.curve.modulus, cfg.num_words, 8, 2
    rng = np.random.default_rng(80)
    vals = [0, 1, p - 1] + [int.from_bytes(rng.bytes(64), "little") % p for _ in range(G * R - 3)]
    lanes = mont_limbs(vals, cfg).reshape(G, R, L)
    lanes[1, 7] = -lanes[1, 7]  # -aR: the value p - a in balanced limbs
    vals[-1] = (p - vals[-1]) % p
    a = np.ascontiguousarray(lanes.transpose(0, 2, 1))
    for e in (0, 1, 2, 15, 16, p - 2, int.from_bytes(rng.bytes(50), "little") | (1 << 399)):
        nw = max(1, (e.bit_length() + 31) // 32)
        ew = np.array([(e >> (32 * i)) & 0xFFFFFFFF for i in range(nw)], dtype=np.uint32)
        (out,) = _run(lib, "h_pow", cfg, [(G, L, R)], a, ew, e.bit_length(), G, R)
        got = [limbs_to_int(out[g, :, r], 13) for g in range(G) for r in range(R)]
        want = [pow(v, e, p) * cfg.r % p for v in vals]
        assert got == want, e
    assert np.array_equal(out, _canonical(cfg, mont_pow_plain(cfg, torch.from_numpy(a), e).transpose(1, 2))
                          .transpose(0, 2, 1))


def _dense(vals, cfg) -> np.ndarray:
    D = coord_words(cfg)
    return np.array([[(v >> (32 * k)) & 0xFFFFFFFF for k in range(D)] for v in vals],
                    dtype=np.uint32).view(np.int32)


@pytest.mark.parametrize("name", NAMES)
def test_sum_is_p_matches_python_ints(lib, name):
    """fe32_sum_is_p (the pair predicates' y1 + y2 == p) on canonical pairs
    whose sum is p, p - 1, p + 1, random, or near 2p; on secp256k1 (p within
    2^33 of 2^256) many of them carry out of the top word, and none of
    those reads as p."""
    cfg = _cfg(name)
    p, D = cfg.curve.modulus, coord_words(cfg)
    rng = np.random.default_rng(81)
    a = [int.from_bytes(rng.bytes(64), "little") % p for _ in range(60)] + [0, 1, p - 1, p - 1]
    b = [(p - x) % p for x in a[:20]] + [(p - x + 1) % p for x in a[20:30]]
    b += [(p - x - 1) % p for x in a[30:40]] + [int.from_bytes(rng.bytes(64), "little") % p for _ in a[40:60]]
    b += [p - 1, p - 1, 1, p - 1]
    near = [p - 1 - int(v) for v in rng.integers(0, 1 << 20, size=16)]  # sums near 2p
    a, b = a + near[:8], b + near[8:]
    (out,) = _run(lib, "h_sum_is_p", cfg, [(len(a),)], _dense(a, cfg), _dense(b, cfg), len(a))
    want = [int(x + y == p) for x, y in zip(a, b)]
    assert out.tolist() == want and sum(want) >= 20
    if name == "secp256k1":
        assert sum(x + y >= 1 << (32 * D) for x, y in zip(a, b)) >= 10


@pytest.mark.parametrize("coords", [2, 3])
@pytest.mark.parametrize("name", NAMES)
def test_pair_denominators_and_predicates_match_twin(lib, name, coords):
    """The pair algebra's predicates and denominators through the full-row
    load and the x-only gather (kernels 10 and 12 read d that way), at
    COORDS 2 and 3, for every pair of a stream with doubling and infinity
    pairs (and, under GLV, equal x across the halves), against the twins'
    predicates and d: the same flags and the same canonical d by both
    routes."""
    cfg = _cfg(name, coords)
    L, (G, Cp, R) = cfg.num_words, (2, 6, 8)
    packed, perm, flags = _stream(cfg, coords, G, Cp, R, seed=82 + coords)
    d1, d2, dbl, inf = _run(lib, "h_denominators", cfg, [(G, Cp, L, R)] * 2 + [(G, Cp, R)] * 2,
                            packed, perm, flags, G, Cp, R, coords)
    _, _, _, _, d, _, wdbl, winf = _pairs_plain(cfg, *map(torch.from_numpy, (packed, perm, flags)))
    assert np.array_equal(dbl, wdbl.numpy()) and np.array_equal(inf, winf.numpy())
    assert dbl.any() and inf.any()
    for got in (d1, d2):
        _assert_canonical_equal(cfg, _limbs_last(got), d)


@pytest.mark.parametrize("coords", [2, 3])
@pytest.mark.parametrize("name", NAMES)
def test_pair_chains_match_twins(lib, name, coords):
    """Kernels 12 and 10's body (pair_chain32_lane walking backwards and
    forwards) at COORDS 2 and 3 for every lane of a stream with doubling
    and infinity pairs where each walk starts, against pair_suffix_plain and
    pair_forward_plain."""
    cfg = _cfg(name, coords)
    L, (G, Cp, R) = cfg.num_words, (2, 5, 8)
    packed, perm, flags = _stream(cfg, coords, G, Cp, R, seed=84 + coords)
    tin = [torch.from_numpy(a) for a in (packed, perm, flags)]
    for forward, twin in ((0, pair_suffix_plain), (1, pair_forward_plain)):
        (out,) = _run(lib, "h_chain", cfg, [(G, Cp, L, R)], packed, perm, flags, G, Cp, R, coords, forward)
        _assert_canonical_equal(cfg, _limbs_last(out), twin(cfg, *tin).transpose(-1, -2))


@pytest.mark.parametrize("coords", [2, 3])
@pytest.mark.parametrize("name", NAMES)
def test_emit_scan_matches_twin(lib, name, coords):
    """Kernel 13's body at COORDS 2 and 3 for every lane, on the suffix
    body's own products and the twin's Fermat inverse of s_0 in balanced
    limbs, against emit_scan_plain: the same canonical pe3 rows (each
    padded with zero limbs to pe3_row_limbs) and lane totals. Grumpkin's
    3b = -51 enters its mixed adds."""
    cfg = _cfg(name, coords)
    L, (G, Cp, R), W = cfg.num_words, (2, 5, 8), pe3_row_limbs(cfg)
    packed, perm, flags = _stream(cfg, coords, G, Cp, R, seed=86 + coords)
    (s,) = _run(lib, "h_chain", cfg, [(G, Cp, L, R)], packed, perm, flags, G, Cp, R, coords, 0)
    t0 = mont_pow_plain(cfg, torch.from_numpy(s[:, 0]), cfg.curve.modulus - 2)
    t0[:, 0] += 1 << cfg.word_size  # the same values in balanced limbs
    t0[:, 1] -= 1
    pe3, tx, ty, tz = _run(lib, "h_emit_scan", cfg, [(G, Cp, R, W)] + [(G, L, R)] * 3,
                           packed, perm, flags, s, t0.numpy(), G, Cp, R, coords)
    assert not pe3[..., 3 * L:].any()
    want = emit_scan_plain(cfg, *map(torch.from_numpy, (packed, perm, flags, s)), t0)
    _assert_canonical_equal(cfg, pe3[..., :3 * L].reshape(G, Cp, R, 3, L), want[0].reshape(G, Cp, R, 3, L))
    for got, w in zip((tx, ty, tz), want[1:]):
        _assert_canonical_equal(cfg, _limbs_last(got), w.transpose(1, 2))


@pytest.mark.parametrize("coords", [2, 3])
@pytest.mark.parametrize("name", NAMES)
def test_pair_backward_matches_twin(lib, name, coords):
    """Kernel 11's body at COORDS 2 and 3 for every lane, on the forward
    body's own products and the twin's inverse of the last, against
    pair_backward_plain: the same pair sums and infinity flags (BN254
    instantiates this kernel; the body is generic)."""
    cfg = _cfg(name, coords)
    L, (G, Cp, R) = cfg.num_words, (2, 4, 8)
    packed, perm, flags = _stream(cfg, coords, G, Cp, R, seed=88 + coords)
    (m,) = _run(lib, "h_chain", cfg, [(G, Cp, L, R)], packed, perm, flags, G, Cp, R, coords, 1)
    minv = mont_pow_plain(cfg, torch.from_numpy(m[:, -1]), cfg.curve.modulus - 2)
    cx, cy, inf = _run(lib, "h_backward", cfg, [(G, Cp, L, R)] * 2 + [(G, Cp, R)],
                       packed, perm, flags, m, minv.numpy(), G, Cp, R, coords)
    wx, wy, winf = pair_backward_plain(cfg, *map(torch.from_numpy, (packed, perm, flags, m)), minv)
    assert np.array_equal(inf, winf.numpy()) and inf.any()
    keep = ~inf.astype(bool)[:, :, None, :].repeat(L, 2)  # an infinity pair's sum means nothing
    for got, want in ((cx, wx), (cy, wy)):
        assert np.array_equal(got[keep], _canonical(cfg, want.transpose(-1, -2)).swapaxes(-1, -2)[keep])


@pytest.mark.parametrize("name", NAMES)
def test_convert_glv_matches_twin(lib, name):
    """Kernel 2's GLV body on every curve, on the u16 words of real points
    and on words anywhere below 2^(32 D), against convert_pack_plain under
    GLV: rows x R, beta x R (the field's compiled-in beta R^2), y R."""
    cfg = _cfg(name, 3)
    wu, n = coord_u16(cfg), 48
    rng = np.random.default_rng(90)
    x, y = pad_points_words(affine_points(cfg, 24, seed=4), cfg, 24)
    rx, ry = (rng.integers(0, 1 << 16, size=(24, wu)).astype(np.uint16).view(np.int16) for _ in range(2))
    rx[0], ry[0] = -1, -1
    xw, yw = np.concatenate([x, rx]), np.concatenate([y, ry])
    (got,) = _run(lib, "h_convert_glv", cfg, [(n, 3 * coord_words(cfg))], xw, yw, n)
    want = convert_pack_plain(cfg, torch.from_numpy(xw), torch.from_numpy(yw)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_scan_glv_matches_twin(lib, name):
    """Kernel 4's GLV body (scan_lane at COORDS 3: x or beta x by flag bit
    1, y from the third coordinate) for every lane of a stream over a GLV
    table of points and their phi images, against scan_rows_plain."""
    cfg = _cfg(name, 3)
    L, (G, C, R), W = cfg.num_words, (2, 5, 8), pe3_row_limbs(cfg)
    _, packed, perm, flags = glv_pair_stream(cfg, G, C + 1, R, nbase=16, seed=91)
    perm, flags = np.ascontiguousarray(perm[:, :C]), np.ascontiguousarray(flags[:, :C])
    pe3, tx, ty, tz = _run(lib, "h_scan_glv", cfg, [(G, C, R, W)] + [(G, L, R)] * 3, packed, perm, flags, G, C, R)
    want = scan_rows_plain(cfg, *map(torch.from_numpy, (packed, perm, flags)))
    _assert_canonical_equal(cfg, pe3[..., :3 * L].reshape(G, C, R, 3, L), want[0].reshape(G, C, R, 3, L))
    for got, w in zip((tx, ty, tz), want[1:]):
        _assert_canonical_equal(cfg, _limbs_last(got), w.transpose(1, 2))

