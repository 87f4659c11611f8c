"""The narrow library's word core (csrc/fe32.cuh and the kernels' bodies
compiled with -DMSM_LIMB_BITS=0, ops/_build.NARROW_FLAGS: the limb width
read at run time from a row of csrc/widths.cuh) built for the host with g++
once and held, for all seven fields at every width 8 to 12 (the row set
with use_width_on_host), against Python integers at R = 2^(W L): the
Montgomery product and the other field operations (TAIL 0 on BLS12-377 at
widths 8 and 12, TAIL 14 on secp256k1 at 9 and Pallas at 10), the limb <->
word repacking through strided memory (L = 49 on BLS12-381 at width 8),
balanced loads in (-R, R), the pe3 row store and its zero padding, kernel
1's point add (point_add_row and its warp form) on real curve points, and
kernel 2's convert in its plain and GLV modes."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import test_torch_fields_host as host
from _torch_helpers import affine_points, mont_limbs, rand_balanced
from msm_tpu_torch.models.common import pad_points_words
from msm_tpu_torch.ops._build import FIELD_FLAGS, NARROW_FLAGS, NARROW_WIDTHS, curve_id
from msm_tpu_torch.ops.cuda_convert import convert_pack_plain, coord_u16
from msm_tpu_torch.ops.cuda_scan import pe3_row_limbs
from msm_tpu_torch.ops.glv import glv_params
from msm_tpu_torch.oracle.pyecc import Curve
from msm_tpu_torch.params import CURVES, MsmConfig
from msm_tpu_torch.utils.limbs import ints_to_limbs, limbs_to_int

HARNESS = r"""
#include "convert32.cuh"
#include "point_add.cuh"
#include "scan.cuh"
using namespace msm;

static_assert(FpBn254::RT && FpBls12_381::RT, "the narrow build");

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

// canonical words [n, NW] -> limbs at limbs[j * n + i] (limbs-first, stride
// n) -> words [n, NW]
template <class F>
struct Repack {
  static void run(const uint32_t* dense, int32_t* limbs, uint32_t* words, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
      fe32t<F> x, y;
      ld(x, dense + i * F::NW);
      fe32_store_limbs_strided(limbs + i, n, x);
      fe32_load_limbs_strided(y, limbs + i, n);
      st(words + i * F::NW, y);
    }
  }
};

// balanced limbs [n, L] -> canonical words [n, NW], row by row and
// limbs-first through a copy at stride n
template <class F>
struct Balanced {
  static void run(const int32_t* a, uint32_t* o, int32_t* scratch, int64_t n) {
    const int L = limb_count<F>();
    for (int64_t i = 0; i < n; ++i)
      for (int j = 0; j < L; ++j) scratch[j * n + i] = a[i * L + j];
    for (int64_t i = 0; i < n; ++i) {
      fe32t<F> x, y;
      fe32_from_balanced(x, a + i * L);
      fe32_load_balanced_strided(y, scratch + i, n);
      st(o + 2 * i * F::NW, x);
      st(o + (2 * i + 1) * F::NW, y);
    }
  }
};

// points [n, 3, NW] (canonical words) -> pe3 rows [n, pe3_row]
template <class F>
struct Pe3 {
  static void run(const uint32_t* w, int32_t* out, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
      pt32t<F> p;
      ld(p.x, w + (3 * i) * F::NW);
      ld(p.y, w + (3 * i + 1) * F::NW);
      ld(p.z, w + (3 * i + 2) * F::NW);
      scan_store_row(out + i * pe3_row_limbs<F>(), p);
    }
  }
};

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
struct Convert {  // xw, yw [n, 2 NW] int16; out [n, 2 NW], or [n, 3 NW] under GLV
  static void run(const int16_t* xw, const int16_t* yw, int32_t* out, int64_t n, int glv) {
    for (int64_t i = 0; i < n; ++i) {
      if (glv)
        convert_point_glv<F>(xw, yw, out, i);
      else
        convert_point<F>(xw, yw, out, i);
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
int h_width(int c, int width) { return use_width_on_host(c, width); }
void h_arith(int c, const uint32_t* a, const uint32_t* b, uint32_t* o, int64_t n) {
  dispatch<Arith>(c, a, b, o, n);
}
void h_reduce(int c, const uint32_t* a, uint32_t* o, int64_t n) { dispatch<Reduce>(c, a, o, n); }
void h_repack(int c, const uint32_t* d, int32_t* l, uint32_t* w, int64_t n) {
  dispatch<Repack>(c, d, l, w, n);
}
void h_balanced(int c, I a, uint32_t* o, O scratch, int64_t n) {
  dispatch<Balanced>(c, a, o, scratch, n);
}
void h_pe3(int c, const uint32_t* w, O out, int64_t n) { dispatch<Pe3>(c, w, out, n); }
void h_point_add(int c, I ax, I ay, I az, I bx, I by, I bz, O ox, O oy, O oz,
                 int64_t n, int lanes) {
  dispatch<PointAdd>(c, ax, ay, az, bx, by, bz, ox, oy, oz, n, lanes);
}
void h_convert(int c, const int16_t* xw, const int16_t* yw, O out, int64_t n, int glv) {
  dispatch<Convert>(c, xw, yw, out, n, glv);
}
}
"""

NAMES = list(CURVES)
CASES = [(name, w) for name in NAMES for w in sorted(NARROW_WIDTHS)]
IDS = [f"{name}-w{w}" for name, w in CASES]


def build_harness(d) -> ctypes.CDLL:
    """HARNESS built with g++ in directory ``d`` as the narrow library's
    sources are (FIELD_FLAGS, NARROW_FLAGS), its entries typed."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available")
    src, so = d / "harness.cpp", d / "harness.so"
    src.write_text(HARNESS)
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC", *FIELD_FLAGS, *NARROW_FLAGS,
                    f"-I{host.CSRC}", "-o", str(so), str(src)],
                   check=True, capture_output=True, text=True, timeout=600)
    lib = ctypes.CDLL(str(so))
    P, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.h_width.argtypes, lib.h_width.restype = [I32, I32], I32
    for name, nargs in (("h_arith", 3), ("h_reduce", 2), ("h_repack", 3), ("h_balanced", 3), ("h_pe3", 2)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [I32] + [P] * nargs + [I64], None
    lib.h_point_add.argtypes, lib.h_point_add.restype = [I32] + [P] * 9 + [I64, I32], None
    lib.h_convert.argtypes, lib.h_convert.restype = [I32] + [P] * 3 + [I64, I32], None
    return lib


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return build_harness(tmp_path_factory.mktemp("fields_narrow"))


def _cfg(name, width, **kw) -> MsmConfig:
    return MsmConfig(curve=CURVES[name], word_size=width, **kw)


def _at(lib, cfg) -> int:
    """Set the host's width block of the config's curve; its curve index."""
    c = curve_id(cfg)
    assert lib.h_width(c, cfg.word_size) == 0
    return c


def test_the_geometry_the_widths_cover(lib):
    """L = ceil((bits + 6) / W) and TAIL = W L - 32 NW over the table: L
    from 22 to 49, TAIL 0 (BLS12-377 at 8 and 12) to 14; a width outside 8
    to 13 has no row."""
    got = {(name, w): (_cfg(name, w).num_words, w * _cfg(name, w).num_words - 32 * host._nw(_cfg(name, w)))
           for name, w in CASES}
    assert got[("bls12_381", 8)] == (49, 8) and got[("bls12_377", 8)] == (48, 0)
    assert got[("bls12_377", 12)] == (32, 0) and got[("secp256k1", 9)] == (30, 14)
    assert got[("pallas", 10)] == (27, 14) and got[("bn254", 11)] == (24, 8)
    assert all(0 <= t < 32 for _, t in got.values())
    assert lib.h_width(0, 7) == -1 and lib.h_width(0, 14) == -1 and lib.h_width(7, 8) == -1


@pytest.mark.parametrize("name, width", CASES, ids=IDS)
def test_arithmetic_at_run_time_widths(lib, name, width):
    """a b R^-1 with R = 2^(W L), the dedicated squaring, a + b, a - b, -a,
    2a and 3b a on the edges and random canonical values."""
    cfg = _cfg(name, width)
    p, nw, rinv = cfg.curve.modulus, host._nw(cfg), pow(cfg.r, -1, cfg.curve.modulus)
    c = _at(lib, cfg)
    rng = np.random.default_rng(80 + width)
    vals = host._canonical_values(rng, p, 40)
    a = vals + [x for x in vals[:7] for _ in range(7)]
    b = vals[::-1] + vals[:7] * 7
    out = np.zeros((len(a), 7, nw), dtype=np.uint32)
    wa, wb = host._words(a, nw), host._words(b, nw)
    lib.h_arith(c, wa.ctypes.data, wb.ctypes.data, out.ctypes.data, len(a))
    b3 = 3 * cfg.curve.b % p
    for i, (x, y) in enumerate(zip(a, b)):
        want = [x * y * rinv % p, x * x * rinv % p, (x + y) % p, (x - y) % p, -x % p, 2 * x % p, b3 * x % p]
        assert host._ints(out[i]) == want, (name, width, i, x, y)


@pytest.mark.parametrize("name, width", CASES, ids=IDS)
def test_limbs_and_words_through_memory(lib, name, width):
    """Canonical words -> W-bit limbs stored limbs-first at a stride -> words,
    against the integers' own limbs."""
    cfg = _cfg(name, width)
    p, nw, L = cfg.curve.modulus, host._nw(cfg), cfg.num_words
    c = _at(lib, cfg)
    vals = host._canonical_values(np.random.default_rng(81 + width), p, 40)
    n = len(vals)
    limbs = np.full((L, n), -1, dtype=np.int32)
    words = np.zeros((n, nw), dtype=np.uint32)
    dense = host._words(vals, nw)
    lib.h_repack(c, dense.ctypes.data, limbs.ctypes.data, words.ctypes.data, n)
    assert np.array_equal(limbs.T, ints_to_limbs(vals, width, L).astype(np.int32))
    assert host._ints(words) == vals


@pytest.mark.parametrize("name, width", CASES, ids=IDS)
def test_balanced_loads_at_run_time_widths(lib, name, width):
    """fe32_from_balanced (a row) and fe32_load_balanced_strided (limbs-first)
    on balanced limbs (signed, a little outside [0, 2^W)), canonical ones and
    the values next to R and -R: the value mod p."""
    cfg = _cfg(name, width)
    p, nw, L = cfg.curve.modulus, host._nw(cfg), cfg.num_words
    c = _at(lib, cfg)
    rng = np.random.default_rng(82 + width)
    bal = rand_balanced(rng, (100,), cfg, spread=60)
    canon = ints_to_limbs(host._canonical_values(rng, p, 10), width, L).astype(np.int32)
    top = np.full((3, L), (1 << width) - 1, dtype=np.int32)  # 2^(W L) - 1
    top[1, -1] = -1
    top[2, :] = 0
    top[2, -1] = -(1 << (width - 1))  # -(R / 2)
    a = np.concatenate([bal, canon, top])
    assert all(-(1 << (width * L)) < limbs_to_int(row, width) < 1 << (width * L) for row in a)
    out = np.zeros((len(a), 2, nw), dtype=np.uint32)
    scratch = np.zeros((L, len(a)), dtype=np.int32)
    lib.h_balanced(c, a.ctypes.data, out.ctypes.data, scratch.ctypes.data, len(a))
    want = [limbs_to_int(row, width) % p for row in a]
    assert host._ints(out[:, 0]) == want and host._ints(out[:, 1]) == want


@pytest.mark.parametrize("name, width", CASES, ids=IDS)
def test_pe3_row_store(lib, name, width):
    """scan_store_row: x || y || z in W-bit limbs, then zeros up to
    pe3_row_limbs (3 L rounded up to a multiple of 4)."""
    cfg = _cfg(name, width)
    p, nw, L = cfg.curve.modulus, host._nw(cfg), cfg.num_words
    c = _at(lib, cfg)
    vals = host._canonical_values(np.random.default_rng(83 + width), p, 23)
    pts = np.array([host._words(vals[3 * i:3 * i + 3], nw) for i in range(len(vals) // 3)])
    row = pe3_row_limbs(cfg)
    out = np.full((len(pts), row), -1, dtype=np.int32)
    lib.h_pe3(c, pts.ctypes.data, out.ctypes.data, len(pts))
    want = ints_to_limbs(vals[:3 * len(pts)], width, L).astype(np.int32).reshape(len(pts), 3 * L)
    assert np.array_equal(out[:, :3 * L], want)
    assert row % 4 == 0 and row - 3 * L < 4 and not out[:, 3 * L:].any()


def _from_mont(rows, cfg) -> list[int]:
    p = cfg.curve.modulus
    rinv = pow(cfg.r, -1, p)
    return [limbs_to_int(row, cfg.word_size) * rinv % p for row in rows]


@pytest.mark.parametrize("name, width", CASES, ids=IDS)
def test_point_add_at_run_time_widths(lib, name, width):
    """Kernel 1's bodies (a thread per add, and the warp's split products)
    on real curve points in random projective form (a doubling, P + (-P),
    the identity and balanced -y among them), as points against the
    oracle's sums."""
    cfg = _cfg(name, width)
    cv, p, L, B = Curve(cfg.curve), cfg.curve.modulus, cfg.num_words, 12
    c = _at(lib, cfg)
    rng = np.random.default_rng(84 + width)
    aff = affine_points(cfg, 6, seed=74)
    a = [aff[i % 6] for i in range(B)]
    b = [aff[(3 * i + 1) % 6] for i in range(B)]
    b[0], b[1] = a[0], (a[1][0], (p - a[1][1]) % p)  # a doubling, an infinity sum
    zs = [[1 + int.from_bytes(rng.bytes(64), "little") % (p - 1) for _ in range(B)] for _ in range(2)]
    ins = []
    for pts, z in zip((a, b), zs):
        ins += [mont_limbs([pt[k] * zz for pt, zz in zip(pts, z)], cfg) for k in range(2)] + [mont_limbs(z, cfg)]
    ins[3][2], ins[4][2], ins[5][2] = 0, mont_limbs([1], cfg)[0], 0  # b[2] the identity
    ins[1][3::3] = -ins[1][3::3]  # balanced -y: the point -a
    ins = [np.ascontiguousarray(t) for t in ins]
    a = [(x, (p - y) % p) if i % 3 == 0 and i else (x, y) for i, (x, y) in enumerate(a)]
    for lanes in (0, 1):
        outs = [np.zeros((B, L), dtype=np.int32) for _ in range(3)]
        lib.h_point_add(c, *(t.ctypes.data for t in ins), *(o.ctypes.data for o in outs), B, lanes)
        assert all(o.min() >= 0 and o.max() < 1 << width for o in outs)
        X, Y, Z = (_from_mont(o, cfg) for o in outs)
        for i in range(B):
            want = cv.from_affine(*a[i]) if i == 2 else cv.add(cv.from_affine(*a[i]), cv.from_affine(*b[i]))
            if want.is_identity():
                assert Z[i] == 0, (name, width, lanes, i)
                continue
            x, y = cv.to_affine(want)
            assert Z[i] != 0 and (X[i], Y[i]) == (x * Z[i] % p, y * Z[i] % p), (name, width, lanes, i)


@pytest.mark.parametrize("name, width", CASES, ids=IDS)
def test_convert_at_run_time_widths(lib, name, width):
    """Kernel 2's body in its plain mode (x R || y R) and its GLV mode (x R
    || beta x R || y R, the width block's beta R^2) on real points' u16
    words and on words anywhere below 2^(32 NW), against the integers and
    against convert_pack_plain at the width."""
    cfg = _cfg(name, width)
    p, nw, wu = cfg.curve.modulus, host._nw(cfg), coord_u16(cfg)
    c = _at(lib, cfg)
    rng = np.random.default_rng(85 + width)
    x, y = pad_points_words(affine_points(cfg, 6, seed=76), cfg, 6)
    rx, ry = (rng.integers(0, 1 << 16, size=(6, wu)).astype(np.uint16).view(np.int16) for _ in range(2))
    rx[0], ry[0] = -1, -1  # 2^(32 NW) - 1
    xw, yw = np.concatenate([x, rx]), np.concatenate([y, ry])
    n = len(xw)
    xs, ys = ([sum(int(v) << (16 * k) for k, v in enumerate(row.view(np.uint16))) for row in w] for w in (xw, yw))
    beta = glv_params(cfg.curve).beta
    for glv, coords in ((0, (xs, ys)), (1, (xs, [v * beta for v in xs], ys))):
        out = np.zeros((n, len(coords) * nw), dtype=np.int32)
        lib.h_convert(c, xw.ctypes.data, yw.ctypes.data, out.ctypes.data, n, glv)
        got = [host._ints(out[:, k * nw:(k + 1) * nw].view(np.uint32)) for k in range(len(coords))]
        assert got == [[v % p * cfg.r % p for v in co] for co in coords], (name, width, glv)
        twin = convert_pack_plain(_cfg(name, width, glv=bool(glv)), torch.from_numpy(xw), torch.from_numpy(yw))
        assert np.array_equal(out, twin.numpy()), (name, width, glv)
