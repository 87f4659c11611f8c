"""The plain path's per-thread kernel bodies on the generic word core,
compiled for the host with g++ for all seven fields and held against the
plain PyTorch twins of the same curve: the point add (kernel 1,
point_add_row and its warp form point_add_row_lanes), the convert (2,
convert_point, on coordinates anywhere below 2^(32 NW)), the scan (4,
scan_lane), the row offsets (5, the three launches' bodies over a plan of
K lanes a thread: the bodies moved onto the word core), the point total
(6, the thread runs and the finishing lanes over their partial words) and
the Horner ladder (7, horner_chain); the scan's pe3 rows padded with zero
limbs to a multiple of 4. Outputs are canonical 13-bit limbs;
where the kernel adds in the twin's order they must equal the twin's
canonical limbs, and where it reassociates (the row offsets, the point
total) they are compared as points, on real curve points."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_helpers import affine_points, mont_limbs, rand_balanced, same_points
from msm_tpu_torch.models.common import pad_points_words
from msm_tpu_torch.ops._build import FIELD_FLAGS, curve_id
from msm_tpu_torch.ops.cuda_convert import convert_pack_plain, coord_u16
from msm_tpu_torch.ops.cuda_curve import point_add_plain
from msm_tpu_torch.ops.cuda_prefix import horner_plain, point_total_plain, row_offsets_plain
from msm_tpu_torch.ops.cuda_scan import pe3_row_limbs, scan_rows_plain
from msm_tpu_torch.ops.field import get_field_ctx
from msm_tpu_torch.params import CURVES, MsmConfig

CSRC = Path(__file__).resolve().parent.parent / "msm_tpu_torch" / "csrc"

HARNESS = r"""
#include <vector>

#include "convert32.cuh"
#include "horner.cuh"
#include "point_total.cuh"
#include "prefix.cuh"
#include "scan.cuh"
using namespace msm;

template <class F>
struct PointAdd {  // rows [n, L]
  static void run(const int32_t* ax, const int32_t* ay, const int32_t* az,
                  const int32_t* bx, const int32_t* by, const int32_t* bz,
                  int32_t* ox, int32_t* oy, int32_t* oz, int64_t n, int lanes) {
    for (int64_t i = 0; i < n; ++i) {
      if (lanes)
        point_add_row_lanes<F>(ax, ay, az, bx, by, bz, ox, oy, oz, i);
      else
        point_add_row<F>(ax, ay, az, bx, by, bz, ox, oy, oz, i);
    }
  }
};

template <class F>
struct Convert {  // xw, yw [n, 2 NW] int16; out [n, 2 NW]
  static void run(const int16_t* xw, const int16_t* yw, int32_t* out, int64_t n) {
    for (int64_t i = 0; i < n; ++i) convert_point<F>(xw, yw, out, i);
  }
};

template <class F>
struct Scan {
  static void run(const int32_t* packed, const int32_t* perm,
                  const int32_t* flags, int32_t* pe3, int32_t* tx, int32_t* ty,
                  int32_t* tz, int64_t G, int C, int R) {
    for (int64_t g = 0; g < G; ++g)
      for (int r = 0; r < R; ++r)
        scan_lane<2, F>(packed, perm, flags, pe3, tx, ty, tz, g, C, R, r);
  }
};

// The row offsets' three launches with blocks of T threads, K lanes each;
// the two block scans run serially here.
template <class F>
struct RowOffsets {
  static void run(const int32_t* tx, const int32_t* ty, const int32_t* tz,
                  int32_t* ox, int32_t* oy, int32_t* oz, int64_t G, int R,
                  int K, int T) {
    constexpr int L = F::L;
    const int nb = (R + K * T - 1) / (K * T);
    std::vector<pt32t<F>> off(nb);
    for (int64_t g = 0; g < G; ++g) {
      for (int b = 0; b < nb; ++b) {
        pt32t<F> run;
        pt32_identity(run);
        for (int j = 0; j < T && (b * T + j) * K < R; ++j) {
          const int r0 = (b * T + j) * K;
          const int64_t o = (g * R + r0) * L;
          pt32t<F> s;
          ro_thread_total(s, tx, ty, tz, g, R, r0, K);
          pt32_store_limbs(ox + o, oy + o, oz + o, 1, run);
          pt32_add(run, run, s);
        }
        off[b] = run;
      }
      pt32t<F> acc;
      pt32_identity(acc);
      for (int b = 0; b < nb; ++b) {
        const pt32t<F> v = off[b];
        off[b] = acc;
        pt32_add(acc, acc, v);
      }
      for (int b = 0; b < nb; ++b)
        for (int j = 0; j < T && (b * T + j) * K < R; ++j) {
          const int r0 = (b * T + j) * K;
          const int64_t o = (g * R + r0) * L;
          pt32t<F> pre, a;
          pt32_load_canonical(pre, ox + o, oy + o, oz + o);
          pt32_add(a, off[b], pre);
          ro_thread_write(a, tx, ty, tz, ox, oy, oz, g, R, r0, K);
        }
    }
  }
};

// The point total's two launches: thread runs of k points, one partial
// (as words) per block of 128 threads summed serially, the finishing
// warp's 32 lanes over the partials, their sum.
template <class F>
struct PointTotal {
  static void run(const int32_t* px, const int32_t* py, const int32_t* pz,
                  int32_t* ox, int32_t* oy, int32_t* oz, int64_t G, int64_t N,
                  int k) {
    const int T = 128;
    const int nb = N > 0 ? (int)((N + (int64_t)T * k - 1) / ((int64_t)T * k)) : 1;
    std::vector<uint32_t> part(G * nb * pt_words<F>);
    for (int64_t g = 0; g < G; ++g) {
      for (int b = 0; b < nb; ++b) {
        pt32t<F> s;
        pt32_identity(s);
        for (int t = 0; t < T; ++t) {
          pt32t<F> v;
          pt_total_run(v, px, py, pz, g, N, k, (int64_t)b * T + t);
          pt32_add(s, s, v);
        }
        pt32_store_words(part.data() + (g * nb + b) * pt_words<F>, s);
      }
      pt32t<F> s;
      pt32_identity(s);
      for (int lane = 0; lane < 32; ++lane) {
        pt32t<F> v;
        pt_total_partials(v, part.data(), g, nb, lane, 32);
        pt32_add(s, s, v);
      }
      pt32_store_limbs(ox + g * F::L, oy + g * F::L, oz + g * F::L, 1, s);
    }
  }
};

template <class F>
struct Horner {  // w* [G, S, L] -> o* [G, L]
  static void run(const int32_t* wx, const int32_t* wy, const int32_t* wz,
                  int32_t* ox, int32_t* oy, int32_t* oz, int64_t G, int S,
                  int chunk) {
    for (int64_t g = 0; g < G; ++g) {
      const int64_t i = g * S * F::L, o = g * F::L;
      std::vector<pt32t<F>> w(S);
      for (int s = 0; s < S; ++s) horner_load(w[s], wx + i, wy + i, wz + i, s);
      pt32t<F> acc;
      horner_chain(acc, w.data(), S, chunk);
      pt32_store_limbs(ox + o, oy + o, oz + o, 1, acc);
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

typedef const int32_t* I;
typedef int32_t* O;
extern "C" {
void h_point_add(int c, I ax, I ay, I az, I bx, I by, I bz, O ox, O oy, O oz,
                 int64_t n, int lanes) {
  dispatch<PointAdd>(c, ax, ay, az, bx, by, bz, ox, oy, oz, n, lanes);
}
void h_convert(int c, const int16_t* xw, const int16_t* yw, O out, int64_t n) {
  dispatch<Convert>(c, xw, yw, out, n);
}
void h_scan(int c, I packed, I perm, I flags, O pe3, O tx, O ty, O tz,
            int64_t G, int C, int R) {
  dispatch<Scan>(c, packed, perm, flags, pe3, tx, ty, tz, G, C, R);
}
void h_row_offsets(int c, I tx, I ty, I tz, O ox, O oy, O oz, int64_t G, int R,
                   int K, int T) {
  dispatch<RowOffsets>(c, tx, ty, tz, ox, oy, oz, G, R, K, T);
}
void h_point_total(int c, I px, I py, I pz, O ox, O oy, O oz, int64_t G,
                   int64_t N, int k) {
  dispatch<PointTotal>(c, px, py, pz, ox, oy, oz, G, N, k);
}
void h_horner(int c, I wx, I wy, I wz, O ox, O oy, O oz, int64_t G, int S,
              int chunk) {
  dispatch<Horner>(c, wx, wy, wz, ox, oy, oz, G, S, chunk);
}
}
"""

NAMES = list(CURVES)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available")
    d = tmp_path_factory.mktemp("fields_bodies_host")
    src, so = d / "harness.cpp", d / "harness.so"
    src.write_text(HARNESS)
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC", *FIELD_FLAGS, f"-I{CSRC}", "-o", str(so), str(src)],
                   check=True, capture_output=True, text=True, timeout=600)
    lib = ctypes.CDLL(str(so))
    P, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for name, argtypes in (("h_point_add", [P] * 9 + [I64, I32]), ("h_convert", [P] * 3 + [I64]),
                           ("h_scan", [P] * 7 + [I64, I32, I32]), ("h_row_offsets", [P] * 6 + [I64, I32, I32, I32]),
                           ("h_point_total", [P] * 6 + [I64, I64, I32]), ("h_horner", [P] * 6 + [I64, I32, I32])):
        fn = getattr(lib, name)
        fn.argtypes = [I32] + argtypes
        fn.restype = None
    return lib


def _run(lib, name, cfg, out_shapes, *args):
    """Call h_<name> on the curve of cfg: numpy arrays pass as pointers
    (int32, or int16 for the convert's words), then fresh int32 outputs of
    out_shapes, then the ints."""
    arrays = [np.ascontiguousarray(a) for a in args if isinstance(a, np.ndarray)]
    ints = [a for a in args if not isinstance(a, np.ndarray)]
    outs = [np.zeros(s, dtype=np.int32) for s in out_shapes]
    getattr(lib, name)(curve_id(cfg), *(a.ctypes.data for a in arrays), *(o.ctypes.data for o in outs), *ints)
    return outs


def _canonical(cfg, t) -> np.ndarray:
    return get_field_ctx(cfg).canonical(torch.as_tensor(t)).numpy()


def _assert_canonical_equal(cfg, got, want):
    assert got.min() >= 0 and got.max() < (1 << cfg.word_size)
    assert np.array_equal(got, _canonical(cfg, want))


def _real_points(cfg, rng, shape, nbase: int = 16, seed: int = 1):
    """Real curve points in random projective form (x z, y z, z), some
    negated in balanced limbs, as numpy [..., L] int32 limbs."""
    f = get_field_ctx(cfg)
    aff = affine_points(cfg, nbase, seed=seed)
    idx = rng.integers(0, nbase, size=shape)
    x, y = (torch.from_numpy(mont_limbs([p[i] for p in aff], cfg))[idx] for i in range(2))
    zs = [int.from_bytes(rng.bytes(64), "little") % cfg.curve.modulus for _ in range(int(np.prod(shape)))]
    z = torch.from_numpy(mont_limbs(zs, cfg)).reshape(*shape, cfg.num_words)
    x, y = f.canonical(f.mont_mul(x, z)), f.canonical(f.mont_mul(y, z))
    neg = torch.from_numpy(rng.random(shape) < 0.3)
    y = torch.where(neg[..., None], -y, y)
    return x.numpy(), y.numpy(), z.numpy()


@pytest.mark.parametrize("name", NAMES)
def test_point_add_rows_match_twin(lib, name):
    """Kernel 1's bodies (a thread per add, and the warp's split products)
    on balanced rows, one operand the identity, against point_add_plain."""
    cfg = MsmConfig(curve=CURVES[name])
    L, B = cfg.num_words, 24
    rng = np.random.default_rng(60)
    ins = [rand_balanced(rng, (B,), cfg) for _ in range(6)]
    ins[3][0], ins[4][0], ins[5][0] = 0, mont_limbs([1], cfg)[0], 0
    want = point_add_plain(cfg, *map(torch.from_numpy, ins))
    for lanes in (0, 1):
        got = _run(lib, "h_point_add", cfg, [(B, L)] * 3, *ins, B, lanes)
        for g, w in zip(got, want):
            _assert_canonical_equal(cfg, g, w)


@pytest.mark.parametrize("name", NAMES)
def test_convert_point_matches_twin(lib, name):
    """Kernel 2's body on u16 coordinate words of real points and on words
    anywhere below 2^(32 NW) (most of them >= p), against
    convert_pack_plain: the same dense words."""
    cfg = MsmConfig(curve=CURVES[name])
    wu, n = coord_u16(cfg), 64
    rng = np.random.default_rng(61)
    x, y = pad_points_words(affine_points(cfg, 32, seed=2), cfg, 32)
    rx, ry = (rng.integers(0, 1 << 16, size=(32, wu)).astype(np.uint16).view(np.int16) for _ in range(2))
    rx[0], ry[0] = -1, -1  # 2^(32 NW) - 1
    xw, yw = np.concatenate([x, rx]), np.concatenate([y, ry])
    assert xw.shape == (n, wu)
    (got,) = _run(lib, "h_convert", cfg, [(n, wu)], xw, yw, n)
    want = convert_pack_plain(cfg, torch.from_numpy(xw), torch.from_numpy(yw)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_scan_lanes_match_twin(lib, name):
    """Kernel 4's body for every lane of a small stream over a table of real
    points (random rows, random signs), against scan_rows_plain: the same
    canonical pe3 rows and lane totals."""
    cfg = MsmConfig(curve=CURVES[name])
    L, (G, C, R), nbase = cfg.num_words, (2, 5, 8), 16
    rng = np.random.default_rng(62)
    x, y = pad_points_words(affine_points(cfg, nbase, seed=3), cfg, nbase)
    packed = convert_pack_plain(cfg, torch.from_numpy(x), torch.from_numpy(y)).numpy()
    perm = rng.integers(0, nbase, size=(G, C, R)).astype(np.int32)
    flags = rng.integers(0, 2, size=(G, C, R)).astype(np.int32)
    P = pe3_row_limbs(cfg)  # 3L padded with zero limbs to a multiple of 4
    pe3, tx, ty, tz = _run(lib, "h_scan", cfg, [(G, C, R, P)] + [(G, L, R)] * 3, packed, perm, flags, G, C, R)
    assert P % 4 == 0 and 0 <= P - 3 * L < 4 and not pe3[..., 3 * L:].any()
    want = scan_rows_plain(cfg, *map(torch.from_numpy, (packed, perm, flags)))
    _assert_canonical_equal(cfg, pe3[..., :3 * L].reshape(G, C, R, 3, L), want[0].reshape(G, C, R, 3, L))
    for g, w in zip((tx, ty, tz), want[1:]):
        _assert_canonical_equal(cfg, g.transpose(0, 2, 1), w.transpose(1, 2))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("K, R, T", [(1, 16, 4), (4, 64, 4), (8, 8, 128)])
def test_row_offsets_threads_match_twin(lib, name, K, R, T):
    """Kernel 5's per-thread bodies, moved onto the word core, for every
    thread of a plan with K lanes per thread and blocks of T threads, on
    real curve points in random projective form (some negated, one the
    identity), against row_offsets_plain as points (the sum is
    reassociated)."""
    cfg = MsmConfig(curve=CURVES[name])
    L, G = cfg.num_words, 2
    rng = np.random.default_rng(63 + K)
    x, y, z = _real_points(cfg, rng, (G, R), seed=K)
    x[1, 0], y[1, 0], z[1, 0] = 0, mont_limbs([1], cfg)[0], 0
    lanes = [np.ascontiguousarray(a.transpose(0, 2, 1)) for a in (x, y, z)]  # [G, L, R]
    got = _run(lib, "h_row_offsets", cfg, [(G, R, L)] * 3, *lanes, G, R, K, T)
    want = row_offsets_plain(cfg, *map(torch.from_numpy, lanes))
    assert all(g.min() >= 0 and g.max() < (1 << cfg.word_size) for g in got)
    assert same_points(got, [w.numpy() for w in want], cfg)


@pytest.mark.parametrize("name", NAMES)
def test_point_total_model_matches_twin(lib, name):
    """Kernel 6's thread runs and finishing lanes (partials as words) over
    real points, k points a thread and more blocks than lanes, against
    point_total_plain as points."""
    cfg = MsmConfig(curve=CURVES[name])
    L, G, N, k = cfg.num_words, 2, 300, 1
    rng = np.random.default_rng(64)
    pts = _real_points(cfg, rng, (G, N), seed=5)
    got = _run(lib, "h_point_total", cfg, [(G, L)] * 3, *pts, G, N, k)
    want = point_total_plain(cfg, *map(torch.from_numpy, pts))
    assert same_points(got, [w.numpy() for w in want], cfg)


@pytest.mark.parametrize("name", NAMES)
def test_horner_chain_matches_twin(lib, name):
    """Kernel 7's load and chain on balanced window sums (some negated, one
    the identity), two ladders at once, against horner_plain."""
    cfg = MsmConfig(curve=CURVES[name])
    L, G, S, chunk = cfg.num_words, 2, 5, 3
    rng = np.random.default_rng(65)
    w = [rand_balanced(rng, (G, S), cfg) for _ in range(3)]
    w[1][:, ::3] *= -1
    w[0][0, 2], w[1][0, 2], w[2][0, 2] = 0, mont_limbs([1], cfg)[0], 0
    got = _run(lib, "h_horner", cfg, [(G, L)] * 3, *w, G, S, chunk)
    want = horner_plain(cfg, *map(torch.from_numpy, w), chunk)
    for g, t in zip(got, want):
        _assert_canonical_equal(cfg, g, t)
