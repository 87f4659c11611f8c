"""The CUDA core (msm_tpu_torch/csrc/field.cuh, curve.cuh, pair.cuh,
prefix.cuh) compiled for the host with g++ and held against the plain
PyTorch twins: Montgomery product, balanced-input canonicalization,
complete addition, mixed addition, doubling, the pair algebra (predicates,
denominator, numerator, emission), the per-lane bodies of the four pair
kernels and of the Fermat inversion that links them (the suffix products,
the inversion and the emission + scan on the word core: pair32.cuh,
pow32.cuh, emit_scan.cuh), run for every lane of a small stream with
planted doubling and infinity pairs, and the per-thread bodies of the row
offsets (on the word core since they moved off the 13-bit one), run for
every thread of the three launches' plan.
Catches arithmetic and indexing faults in the device code without a GPU.
Outputs of the core must be canonical and equal to the twins' results after
canonical()."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_helpers import (affine_points, mont_limbs, pair_stream, rand_balanced, rand_canonical,
                            same_points)
from msm_tpu_torch.ops import cuda_compress as cc
from msm_tpu_torch.ops._build import FIELD_FLAGS
from msm_tpu_torch.ops.cuda_curve import b3_mont_limbs, point_add_plain
from msm_tpu_torch.ops.cuda_inv import mont_pow_plain
from msm_tpu_torch.ops.cuda_prefix import row_offsets_plain
from msm_tpu_torch.ops.cuda_scan import rcb16_madd_plain
from msm_tpu_torch.ops.curve import CurveCtx, PointBatch
from msm_tpu_torch.ops.field import get_field_ctx
from msm_tpu_torch.params import BN254, MsmConfig

CSRC = Path(__file__).resolve().parent.parent / "msm_tpu_torch" / "csrc"
CFG = MsmConfig(curve=BN254)
F = get_field_ctx(CFG)
L = CFG.num_words

HARNESS = r"""
#include <vector>

#include "emit_scan.cuh"
#include "pair.cuh"
#include "pow32.cuh"
#include "prefix.cuh"
using namespace msm;

static void load_pt(point& p, const int32_t* a) {
  fe_from_balanced(p.x, a);
  fe_from_balanced(p.y, a + L);
  fe_from_balanced(p.z, a + 2 * L);
}
static void store_pt(int32_t* o, const point& p) {
  fe_store(o, p.x);
  fe_store(o + L, p.y);
  fe_store(o + 2 * L, p.z);
}
static void load_fe(fe& x, const int32_t* a) {
  for (int i = 0; i < L; ++i) x.v[i] = (uint32_t)a[i];
}

extern "C" {
void h_fe_mul(const int32_t* a, const int32_t* b, int32_t* o, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    fe x, y, r;
    load_fe(x, a + i * L);
    load_fe(y, b + i * L);
    fe_mul(r, x, y);
    fe_store(o + i * L, r);
  }
}
void h_from_balanced(const int32_t* a, int32_t* o, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    fe r;
    fe_from_balanced(r, a + i * L);
    fe_store(o + i * L, r);
  }
}
void h_pt_add(const int32_t* p, const int32_t* q, int32_t* o, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    point a, b, r;
    load_pt(a, p + i * 3 * L);
    load_pt(b, q + i * 3 * L);
    pt_add(r, a, b);
    store_pt(o + i * 3 * L, r);
  }
}
void h_pt_madd(const int32_t* p, const int32_t* xy, int32_t* o, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    point a, r;
    fe x, y;
    load_pt(a, p + i * 3 * L);
    load_fe(x, xy + i * 2 * L);
    load_fe(y, xy + i * 2 * L + L);
    pt_madd(r, a, x, y);
    store_pt(o + i * 3 * L, r);
  }
}
void h_pt_double(const int32_t* p, int32_t* o, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    point a, r;
    load_pt(a, p + i * 3 * L);
    pt_double(r, a);
    store_pt(o + i * 3 * L, r);
  }
}
// xy [n, 4, L] canonical x1, y1, x2, y2; sg [n, 2] signs; inv [n, L];
// o [n, 5, L]: d, num, x3, y3, then (dbl, inf) in the last row's limbs 0, 1
void h_pair(const int32_t* xy, const int32_t* sg, const int32_t* inv,
            int32_t* o, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    fe c[4], iv, d, num, x3, y3;
    for (int k = 0; k < 4; ++k) load_fe(c[k], xy + (i * 4 + k) * L);
    load_fe(iv, inv + i * L);
    pair_t pr;
    pair_make(pr, c[0], c[1], sg[2 * i], c[2], c[3], sg[2 * i + 1]);
    pair_denominator(d, pr);
    pair_numerator(num, pr);
    pair_emit(x3, y3, pr, num, iv);
    int32_t* out = o + i * 5 * L;
    fe_store(out, d);
    fe_store(out + L, num);
    fe_store(out + 2 * L, x3);
    fe_store(out + 3 * L, y3);
    out[4 * L] = pr.dbl;
    out[4 * L + 1] = pr.inf;
  }
}
// kernel 9's body on the word core: a, o [B, L, R]; e: exponent words,
// least significant first
void h_pow(const int32_t* a, int32_t* o, const uint32_t* e, int nbits,
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
// kernel 12's body on the word core
void h_pair_suffix(const int32_t* pk, const int32_t* pm, const int32_t* fl,
                   int32_t* s, int64_t G, int Cp, int R) {
  for (int64_t g = 0; g < G; ++g)
    for (int r = 0; r < R; ++r) pair_chain32_lane<2, false>(pk, pm, fl, s, g, Cp, R, r);
}
void h_pair_forward(const int32_t* pk, const int32_t* pm, const int32_t* fl,
                    int32_t* m, int64_t G, int Cp, int R) {
  for (int64_t g = 0; g < G; ++g)
    for (int r = 0; r < R; ++r) pair_forward_lane(pk, pm, fl, m, g, Cp, R, r);
}
void h_emit_scan(const int32_t* pk, const int32_t* pm, const int32_t* fl,
                 const int32_t* s, const int32_t* t0, int32_t* pe3,
                 int32_t* tx, int32_t* ty, int32_t* tz, int64_t G, int Cp,
                 int R) {
  for (int64_t g = 0; g < G; ++g)
    for (int r = 0; r < R; ++r)
      emit_scan_lane(pk, pm, fl, s, t0, pe3, tx, ty, tz, g, Cp, R, r);
}
void h_pair_backward(const int32_t* pk, const int32_t* pm, const int32_t* fl,
                     const int32_t* m, const int32_t* minv, int32_t* cx,
                     int32_t* cy, int32_t* inf, int64_t G, int Cp, int R) {
  for (int64_t g = 0; g < G; ++g)
    for (int r = 0; r < R; ++r)
      pair_backward_lane(pk, pm, fl, m, minv, cx, cy, inf, g, Cp, R, r);
}
}

// The row offsets' three launches with blocks of T threads, K lanes each,
// on the word core (csrc/prefix.cuh); the two block scans run serially
// here.
extern "C" void h_row_offsets(const int32_t* tx, const int32_t* ty,
                              const int32_t* tz, int32_t* ox, int32_t* oy,
                              int32_t* oz, int64_t G, int R, int K, int T) {
  const int nb = (R + K * T - 1) / (K * T);
  std::vector<pt32> off(nb);
  for (int64_t g = 0; g < G; ++g) {
    for (int b = 0; b < nb; ++b) {  // 1: in-block prefixes, block totals
      pt32 run;
      pt32_identity(run);
      for (int j = 0; j < T && (b * T + j) * K < R; ++j) {
        const int r0 = (b * T + j) * K;
        const int64_t o = (g * R + r0) * L;
        pt32 s;
        ro_thread_total(s, tx, ty, tz, g, R, r0, K);
        pt32_store_limbs(ox + o, oy + o, oz + o, 1, run);
        pt32_add(run, run, s);
      }
      off[b] = run;
    }
    pt32 acc;  // 2: exclusive block offsets
    pt32_identity(acc);
    for (int b = 0; b < nb; ++b) {
      const pt32 v = off[b];
      off[b] = acc;
      pt32_add(acc, acc, v);
    }
    for (int b = 0; b < nb; ++b)  // 3: write-out
      for (int j = 0; j < T && (b * T + j) * K < R; ++j) {
        const int r0 = (b * T + j) * K;
        const int64_t o = (g * R + r0) * L;
        pt32 pre, a;
        pt32_load_canonical(pre, ox + o, oy + o, oz + o);
        pt32_add(a, off[b], pre);
        ro_thread_write(a, tx, ty, tz, ox, oy, oz, g, R, r0, K);
      }
  }
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available")
    d = tmp_path_factory.mktemp("csrc_host")
    src = d / "harness.cpp"
    src.write_text(HARNESS)
    so = d / "harness.so"
    subprocess.run(
        [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", *FIELD_FLAGS, f"-I{CSRC}", "-o", str(so), str(src)],
        check=True, capture_output=True, text=True, timeout=600,
    )
    lib = ctypes.CDLL(str(so))
    P, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for name, nargs in (("h_fe_mul", 3), ("h_from_balanced", 2), ("h_pt_add", 3),
                        ("h_pt_madd", 3), ("h_pt_double", 2), ("h_pair", 4)):
        fn = getattr(lib, name)
        fn.argtypes = [P] * nargs + [I64]
        fn.restype = None
    lanes = [I64, I32, I32]  # G, Cp, R
    for name, argtypes in (("h_pow", [P] * 3 + [I32, I64, I32]),
                           ("h_pair_suffix", [P] * 4 + lanes),
                           ("h_pair_forward", [P] * 4 + lanes),
                           ("h_emit_scan", [P] * 9 + lanes),
                           ("h_pair_backward", [P] * 8 + lanes),
                           ("h_row_offsets", [P] * 6 + [I64, I32, I32, I32])):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None
    return lib


def _call(lib, name, out_shape, *arrays):
    arrays = [np.ascontiguousarray(a, dtype=np.int32) for a in arrays]
    out = np.zeros(out_shape, dtype=np.int32)
    getattr(lib, name)(*(a.ctypes.data for a in arrays), out.ctypes.data, out_shape[0])
    return out


def _assert_canonical_equal(got, twin):
    """got: canonical from the core; twin: any representation (torch)."""
    assert got.min() >= 0 and got.max() < (1 << CFG.word_size)
    want = F.canonical(twin).numpy()
    assert np.array_equal(got, want)


def test_mont_mul_and_from_balanced(lib):
    rng = np.random.default_rng(21)
    a, b = rand_canonical(rng, (200,), CFG), rand_canonical(rng, (200,), CFG)
    a[0], b[1] = 0, 0
    got = _call(lib, "h_fe_mul", (200, L), a, b)
    _assert_canonical_equal(got, F.mont_mul(torch.from_numpy(a), torch.from_numpy(b)))
    # balanced inputs, including negative values and magnitude-R offsets
    x = rand_balanced(rng, (200,), CFG)
    x[:50] = -x[:50]
    x[50:60, -1] -= 1 << CFG.word_size
    got = _call(lib, "h_from_balanced", (200, L), x)
    _assert_canonical_equal(got, torch.from_numpy(x))


def _rand_points(rng, n):
    """Random coordinates (any field elements; the formulas are algebraic)
    plus the identity and P == Q / P == -Q rows."""
    pts = np.stack([rand_balanced(rng, (n,), CFG) for _ in range(3)], axis=1)
    pts[0, 0], pts[0, 1], pts[0, 2] = 0, F.r_limbs, 0  # identity
    return pts


def test_point_add_matches_twin(lib):
    rng = np.random.default_rng(22)
    p, q = _rand_points(rng, 64), _rand_points(rng, 64)
    q[1] = p[1]  # P + P
    q[2, 0], q[2, 2] = p[2, 0], p[2, 2]
    q[2, 1] = -p[2, 1]  # P + (-P)
    got = _call(lib, "h_pt_add", (64, 3, L), p, q)
    tp, tq = torch.from_numpy(p), torch.from_numpy(q)
    want = point_add_plain(CFG, tp[:, 0], tp[:, 1], tp[:, 2], tq[:, 0], tq[:, 1], tq[:, 2])
    for i in range(3):
        _assert_canonical_equal(got[:, i], want[i])


def test_mixed_add_and_double_match_twins(lib):
    rng = np.random.default_rng(23)
    p = _rand_points(rng, 64)
    xy = np.stack([rand_canonical(rng, (64,), CFG) for _ in range(2)], axis=1)
    got = _call(lib, "h_pt_madd", (64, 3, L), p, xy)
    tp, txy = torch.from_numpy(p), torch.from_numpy(xy)
    b3m = torch.from_numpy(b3_mont_limbs(CFG))
    want = rcb16_madd_plain(F, b3m, tp[:, 0], tp[:, 1], tp[:, 2], txy[:, 0], txy[:, 1])
    for i in range(3):
        _assert_canonical_equal(got[:, i], want[i])
    got = _call(lib, "h_pt_double", (64, 3, L), p)
    want = CurveCtx(CFG).double(PointBatch(tp[:, 0], tp[:, 1], tp[:, 2]))
    for i in range(3):
        _assert_canonical_equal(got[:, i], want[i])


def _assert_limbs_first_equal(got, twin):
    """The same for limbs-first [..., L, R] arrays."""
    _assert_canonical_equal(np.ascontiguousarray(got.swapaxes(-1, -2)), twin.transpose(-1, -2))


def _run(lib, name, outs, *args):
    """Call a harness function on numpy int32 inputs and freshly zeroed
    outputs of the given shapes; ints pass as they are."""
    arrays = [np.ascontiguousarray(a, dtype=np.int32) if isinstance(a, np.ndarray) else a
              for a in args]
    out = [np.zeros(shape, dtype=np.int32) for shape in outs]
    ptrs = [a.ctypes.data if isinstance(a, np.ndarray) else a for a in arrays]
    n_in = sum(isinstance(a, np.ndarray) for a in arrays)
    getattr(lib, name)(*ptrs[:n_in], *(o.ctypes.data for o in out), *ptrs[n_in:])
    return out


def test_pair_algebra_matches_twins(lib):
    """Predicates, denominator, numerator and emission on generic,
    doubling and infinity pairs of canonical coordinates."""
    rng = np.random.default_rng(24)
    n = 96
    xy = np.stack([rand_canonical(rng, (n,), CFG) for _ in range(4)], axis=1)
    sg = rng.integers(0, 2, size=(n, 2)).astype(np.int32)
    p = np.asarray(F.p_limbs, dtype=np.int64)
    for i in range(0, n, 3):  # doubling: e2 == e1
        xy[i, 2] = xy[i, 0]
        if sg[i, 0] == sg[i, 1]:
            xy[i, 3] = xy[i, 1]
        else:
            xy[i, 3] = F.canonical(torch.from_numpy((p - xy[i, 1]).astype(np.int32))).numpy()
    for i in range(1, n, 3):  # infinity: e2 == -e1
        xy[i, 2] = xy[i, 0]
        sg[i, 1] = 1 - sg[i, 0]
        xy[i, 3] = xy[i, 1]
    xy[2, 2] = xy[2, 0]
    sg[2] = (0, 0)
    xy[2, 3] = F.canonical(torch.from_numpy((p - xy[2, 1]).astype(np.int32))).numpy()  # inf, same sign
    inv = rand_canonical(rng, (n,), CFG)
    (got,) = _run(lib, "h_pair", [(n, 5, L)], xy, sg, inv, n)

    t = torch.from_numpy(xy)
    x1, y1, x2, y2 = t.unbind(1)
    s1, s2 = torch.from_numpy(sg).unbind(1)
    dbl, inf = cc.pair_predicates_plain(CFG, x1, y1, s1, x2, y2, s2)
    assert dbl[0::3].all() and inf[1::3].all() and inf[2] and not (dbl & inf).any()
    assert np.array_equal(got[:, 4, 0], dbl.numpy()) and np.array_equal(got[:, 4, 1], inf.numpy())
    y1p, y2p = cc.signed_y_plain(F, y1, s1), cc.signed_y_plain(F, y2, s2)
    d = cc.pair_denominator_plain(F, x1, y1p, x2, dbl, inf)
    num = cc.pair_numerator_plain(F, x1, y1p, y2p, dbl)
    x3, y3 = cc.pair_emit_plain(F, num, torch.from_numpy(inv), x1, x2, y1p)
    for k, want in enumerate((d, num, x3, y3)):
        _assert_canonical_equal(got[:, k], want)


def test_pow_matches_twin(lib):
    """Kernel 9's body (the word core's 4-bit window) on balanced lanes."""
    rng = np.random.default_rng(25)
    a = rand_balanced(rng, (2, 8), CFG).transpose(0, 2, 1)  # [B, L, R]
    for e in (0, 1, 5, CFG.curve.modulus - 2):
        nw = max(1, (e.bit_length() + 31) // 32)
        words = (ctypes.c_uint32 * nw)(*((e >> (32 * i)) & 0xFFFFFFFF for i in range(nw)))
        (got,) = _run(lib, "h_pow", [a.shape], a, ctypes.addressof(words), e.bit_length(), 2, 8)
        _assert_limbs_first_equal(got, mont_pow_plain(CFG, torch.from_numpy(np.ascontiguousarray(a)), e))


def test_pair_kernel_lanes_match_twins(lib):
    """The four pair kernels' per-lane bodies and kernel 9's, run for every
    lane, against the twins: suffix -> (inverse of s_0) -> emit+scan on the
    word core, forward -> (inverse of m_last) -> backward."""
    G, Cp, R = 2, 4, 16
    _, packed, perm, flags = pair_stream(CFG, G, 2 * Cp, R, nbase=6, seed=26)
    tp, tm, tf = (torch.from_numpy(a) for a in (packed, perm, flags))
    e = CFG.curve.modulus - 2
    words = (ctypes.c_uint32 * 8)(*((e >> (32 * i)) & 0xFFFFFFFF for i in range(8)))
    chain = (G, Cp, L, R)

    (s,) = _run(lib, "h_pair_suffix", [chain], packed, perm, flags, G, Cp, R)
    _assert_limbs_first_equal(s, cc.pair_suffix_plain(CFG, tp, tm, tf))
    (t0,) = _run(lib, "h_pow", [(G, L, R)], s[:, 0], ctypes.addressof(words), e.bit_length(), G, R)
    got = _run(lib, "h_emit_scan", [(G, Cp, R, 3 * L)] + [(G, L, R)] * 3,
               packed, perm, flags, s, t0, G, Cp, R)
    want = cc.emit_scan_plain(CFG, tp, tm, tf, torch.from_numpy(s), torch.from_numpy(t0))
    for i in range(3):  # pe3 rows: x || y || z
        _assert_canonical_equal(got[0][..., i * L:(i + 1) * L], want[0][..., i * L:(i + 1) * L])
    for g, w in zip(got[1:], want[1:]):
        _assert_limbs_first_equal(g, w)

    (m,) = _run(lib, "h_pair_forward", [chain], packed, perm, flags, G, Cp, R)
    _assert_limbs_first_equal(m, cc.pair_forward_plain(CFG, tp, tm, tf))
    (minv,) = _run(lib, "h_pow", [(G, L, R)], m[:, -1], ctypes.addressof(words), e.bit_length(), G, R)
    cx, cy, inf = _run(lib, "h_pair_backward", [chain, chain, (G, Cp, R)],
                       packed, perm, flags, m, minv, G, Cp, R)
    wx, wy, winf = cc.pair_backward_plain(CFG, tp, tm, tf, torch.from_numpy(m), torch.from_numpy(minv))
    _assert_limbs_first_equal(cx, wx)
    _assert_limbs_first_equal(cy, wy)
    assert np.array_equal(inf, winf.numpy()) and inf.any() and not inf.all()


@pytest.mark.parametrize("K, R, T", [(1, 64, 4), (2, 64, 4), (4, 64, 4), (8, 64, 4), (8, 8, 128),
                                     (1, 1, 128)])
def test_row_offsets_threads_match_twin(lib, K, R, T):
    """Kernel 5's per-thread bodies for every thread of a plan with K lanes
    per thread and blocks of T threads (several blocks, ragged last ones
    and a lone lane included), on real curve points in random projective
    form, some with negated (balanced) y and one the identity, against the
    twin as points (the sum is reassociated)."""
    G = 2
    rng = np.random.default_rng(28 + K)
    aff = affine_points(CFG, 16, seed=K)
    idx = rng.integers(0, 16, size=(G, R))
    x, y = (torch.from_numpy(mont_limbs([p[i] for p in aff], CFG))[idx] for i in range(2))
    z = torch.from_numpy(rand_canonical(rng, (G, R), CFG))
    x, y = F.canonical(F.mont_mul(x, z)), F.canonical(F.mont_mul(y, z))
    neg = torch.from_numpy(rng.random((G, R)) < 0.3)
    y = torch.where(neg[..., None], -y, y)  # -P in balanced limbs
    x[1, 0], y[1, 0], z[1, 0] = 0, torch.from_numpy(F.r_limbs.astype(np.int32)), 0
    lanes = [a.transpose(1, 2).contiguous() for a in (x, y, z)]  # [G, L, R]
    got = _run(lib, "h_row_offsets", [(G, R, L)] * 3, *(a.numpy() for a in lanes), G, R, K, T)
    want = row_offsets_plain(CFG, *lanes)
    assert all(g.min() >= 0 and g.max() < (1 << CFG.word_size) for g in got)
    assert same_points(got, [w.numpy() for w in want], CFG)
