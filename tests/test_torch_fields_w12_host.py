"""The word core at 12-bit limbs (csrc/fe32.cuh over the 12-bit traits
tables of csrc/fields.cuh, selected by -DMSM_LIMB_BITS=12 as in the
library ops/_build.py builds for word_size 12) compiled for the host with
g++ for all seven fields and held against Python integers at R = 2^(12 L):
the Montgomery product and the other field operations (BLS12-377 at TAIL
0, where R = 2^(32 NW) and the REDC has no tail step; BLS12-381 at 12
words and L = 33), the 12-bit limb <-> word repacking, balanced loads in
(-R, R), kernel 1's point add (point_add_row and its warp form) on real
curve points, and kernel 2's convert in its plain and GLV modes (the
beta R^2 row) on coordinates below p and anywhere below 2^(32 NW)."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_fields_host as host
from _torch_helpers import affine_points, mont_limbs, rand_balanced
from msm_tpu_torch.models.common import pad_points_words
from msm_tpu_torch.ops._build import FIELD_FLAGS, curve_id, width_flags
from msm_tpu_torch.ops.cuda_convert import convert_pack_plain, coord_u16
from msm_tpu_torch.oracle.pyecc import Curve
from msm_tpu_torch.params import CURVES, MsmConfig
from msm_tpu_torch.utils.limbs import ints_to_limbs, limbs_to_int

CSRC = Path(__file__).resolve().parent.parent / "msm_tpu_torch" / "csrc"

BODIES = r"""
#include "convert32.cuh"
#include "point_add.cuh"
using namespace msm;

static_assert(FpBn254::W == 12 && FpBls12_377::TAIL == 0 && FpBls12_381::L == 33,
              "the 12-bit traits tables");

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


def _gxx_build(d: Path, source: str) -> ctypes.CDLL:
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available")
    src, so = d / "harness.cpp", d / "harness.so"
    src.write_text(source)
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC", *FIELD_FLAGS, *width_flags(12), f"-I{CSRC}",
                    "-o", str(so), str(src)], check=True, capture_output=True, text=True, timeout=600)
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    """test_torch_fields_host's harness (product, squaring, add, sub, neg,
    double, 3b, full reduction, repacking, balanced load) at 12-bit limbs."""
    lib = _gxx_build(tmp_path_factory.mktemp("fields_w12_core"), host.HARNESS)
    P, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for name, nargs in (("h_arith", 3), ("h_reduce", 2), ("h_repack", 3), ("h_balanced", 2)):
        fn = getattr(lib, name)
        fn.argtypes = [I32] + [P] * nargs + [I64]
        fn.restype = None
    return lib


@pytest.fixture(scope="module")
def bodies(tmp_path_factory):
    lib = _gxx_build(tmp_path_factory.mktemp("fields_w12_bodies"), BODIES)
    P, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.h_point_add.argtypes, lib.h_point_add.restype = [I32] + [P] * 9 + [I64, I32], None
    lib.h_convert.argtypes, lib.h_convert.restype = [I32] + [P] * 3 + [I64, I32], None
    return lib


def _cfg(name) -> MsmConfig:
    return MsmConfig(curve=CURVES[name], word_size=12)


def test_width12_shapes():
    """The limb counts and tails the 12-bit tables cover: L = ceil((bits +
    6) / 12), TAIL = 12 L - 32 NW."""
    got = {name: (_cfg(name).num_words, 12 * _cfg(name).num_words - 32 * host._nw(_cfg(name))) for name in NAMES}
    assert got == {"bn254": (22, 8), "grumpkin": (22, 8), "pallas": (22, 8), "vesta": (22, 8),
                   "secp256k1": (22, 8), "bls12_381": (33, 12), "bls12_377": (32, 0)}


@pytest.mark.parametrize("name", NAMES)
def test_arithmetic_at_12_bits(core, name):
    """a b R^-1 with R = 2^(12 L), the dedicated squaring, a + b, a - b,
    -a, 2a and 3b a on the edges and random canonical values; the full
    reduction of values anywhere below 2^(32 NW)."""
    cfg = _cfg(name)
    p, nw, rinv = cfg.curve.modulus, host._nw(cfg), pow(cfg.r, -1, cfg.curve.modulus)
    assert cfg.r == (1 << (12 * cfg.num_words)) % p
    rng = np.random.default_rng(70)
    vals = host._canonical_values(rng, p, 150)
    a = vals + [x for x in vals[:7] for _ in range(7)]
    b = vals[::-1] + vals[:7] * 7
    out = host._run(core, "h_arith", cfg, (len(a), 7, nw), np.uint32, host._words(a, nw), host._words(b, nw))
    b3 = 3 * cfg.curve.b % p
    for i, (x, y) in enumerate(zip(a, b)):
        want = [x * y * rinv % p, x * x * rinv % p, (x + y) % p, (x - y) % p, -x % p, 2 * x % p, b3 * x % p]
        assert host._ints(out[i]) == want, (name, i, x, y)
    top = 1 << (32 * nw)
    big = [0, p - 1, p, top - 1, top - p] + [int.from_bytes(rng.bytes(4 * nw), "little") for _ in range(100)]
    out = host._run(core, "h_reduce", cfg, (len(big), nw), np.uint32, host._words(big, nw))
    assert host._ints(out) == [v % p for v in big]


@pytest.mark.parametrize("name", NAMES)
def test_limbs_and_words_at_12_bits(core, name):
    """Canonical words -> 12-bit limbs -> words, against the integers' own
    12-bit limbs."""
    cfg = _cfg(name)
    p, nw, L = cfg.curve.modulus, host._nw(cfg), cfg.num_words
    vals = host._canonical_values(np.random.default_rng(71), p, 100)
    dense = host._words(vals, nw).view(np.int32)
    limbs = np.zeros((len(vals), L), dtype=np.int32)
    words = np.zeros((len(vals), nw), dtype=np.uint32)
    core.h_repack(curve_id(cfg), dense.ctypes.data, limbs.ctypes.data, words.ctypes.data, len(vals))
    assert np.array_equal(limbs, ints_to_limbs(vals, 12, L).astype(np.int32))
    assert limbs.max() < 1 << 12
    assert host._ints(words) == vals


@pytest.mark.parametrize("name", NAMES)
def test_balanced_loads_at_12_bits(core, name):
    """fe32_from_balanced on balanced 12-bit limbs (signed, a little outside
    [0, 2^12)), on canonical ones and on the values next to R and -R
    (2^(12 L) - 1, and -(2^(12 (L - 1))) plus lower limbs): the value mod p."""
    cfg = _cfg(name)
    p, nw, L = cfg.curve.modulus, host._nw(cfg), cfg.num_words
    rng = np.random.default_rng(72)
    bal = rand_balanced(rng, (300,), cfg)
    canon = ints_to_limbs(host._canonical_values(rng, p, 20), 12, L).astype(np.int32)
    top = np.full((3, L), (1 << 12) - 1, dtype=np.int32)
    top[1, -1] = -1
    top[2, :] = 0
    top[2, -1] = -(1 << 11)  # -(R / 2)
    a = np.concatenate([bal, canon, top])
    assert all(-(1 << (12 * L)) < limbs_to_int(row, 12) < 1 << (12 * L) for row in a)
    out = host._run(core, "h_balanced", cfg, (len(a), nw), np.uint32, a)
    assert host._ints(out) == [limbs_to_int(row, 12) % p for row in a]


def _from_mont(rows, cfg) -> list[int]:
    p = cfg.curve.modulus
    rinv = pow(cfg.r, -1, p)
    return [limbs_to_int(row, 12) * rinv % p for row in rows]


@pytest.mark.parametrize("name", NAMES)
def test_point_add_at_12_bits(bodies, name):
    """Kernel 1's bodies (a thread per add, and the warp's split products)
    on real curve points in random projective form (some y negated in
    balanced limbs; doublings, P + (-P) and the identity among them), as
    points against the oracle's sums."""
    cfg = _cfg(name)
    cv, p, L, B = Curve(cfg.curve), cfg.curve.modulus, cfg.num_words, 24
    rng = np.random.default_rng(73)
    aff = affine_points(cfg, 8, seed=74)
    a = [aff[i % 8] for i in range(B)]
    b = [aff[(3 * i + 1) % 8] for i in range(B)]
    b[0], b[1] = a[0], (a[1][0], (p - a[1][1]) % p)  # a doubling, an infinity sum
    zs = [[1 + int.from_bytes(rng.bytes(64), "little") % (p - 1) for _ in range(B)] for _ in range(2)]
    ins = []
    for pts, z in zip((a, b), zs):
        ins += [mont_limbs([pt[k] * zz for pt, zz in zip(pts, z)], cfg) for k in range(2)] + [mont_limbs(z, cfg)]
    ins[3][2], ins[4][2], ins[5][2] = 0, mont_limbs([1], cfg)[0], 0  # b[2] the identity
    ins[1][3::3] = -ins[1][3::3]  # balanced -y: the point -a
    a = [(x, (p - y) % p) if i % 3 == 0 and i else (x, y) for i, (x, y) in enumerate(a)]
    for lanes in (0, 1):
        outs = [np.zeros((B, L), dtype=np.int32) for _ in range(3)]
        bodies.h_point_add(curve_id(cfg), *(np.ascontiguousarray(t).ctypes.data for t in ins),
                           *(o.ctypes.data for o in outs), B, lanes)
        assert all(o.min() >= 0 and o.max() < 1 << 12 for o in outs)
        X, Y, Z = (_from_mont(o, cfg) for o in outs)
        for i in range(B):
            want = cv.from_affine(*a[i]) if i == 2 else cv.add(cv.from_affine(*a[i]), cv.from_affine(*b[i]))
            if want.is_identity():
                assert Z[i] == 0, (name, lanes, i)
                continue
            x, y = cv.to_affine(want)
            assert Z[i] != 0 and (X[i], Y[i]) == (x * Z[i] % p, y * Z[i] % p), (name, lanes, i)


@pytest.mark.parametrize("name", NAMES)
def test_convert_at_12_bits(bodies, name):
    """Kernel 2's body in its plain mode (rows x R || y R) and its GLV mode
    (x R || beta x R || y R, the beta R^2 constant of the 12-bit table) on
    real points' u16 words and on words anywhere below 2^(32 NW), against
    the integers and against convert_pack_plain at word_size 12."""
    cfg = _cfg(name)
    p, nw, wu = cfg.curve.modulus, host._nw(cfg), coord_u16(cfg)
    rng = np.random.default_rng(75)
    x, y = pad_points_words(affine_points(cfg, 16, seed=76), cfg, 16)
    rx, ry = (rng.integers(0, 1 << 16, size=(16, wu)).astype(np.uint16).view(np.int16) for _ in range(2))
    rx[0], ry[0] = -1, -1  # 2^(32 NW) - 1
    xw, yw = np.concatenate([x, rx]), np.concatenate([y, ry])
    n = len(xw)
    xs, ys = ([sum(int(v) << (16 * k) for k, v in enumerate(row.view(np.uint16))) for row in w] for w in (xw, yw))
    from msm_tpu_torch.ops.glv import glv_params

    beta = glv_params(cfg.curve).beta
    for glv, coords in ((0, (xs, ys)), (1, (xs, [v * beta for v in xs], ys))):
        out = np.zeros((n, len(coords) * nw), dtype=np.int32)
        bodies.h_convert(curve_id(cfg), xw.ctypes.data, yw.ctypes.data, out.ctypes.data, n, glv)
        got = [host._ints(out[:, k * nw:(k + 1) * nw].view(np.uint32)) for k in range(len(coords))]
        assert got == [[v % p * cfg.r % p for v in c] for c in coords], (name, glv)
        twin = convert_pack_plain(MsmConfig(curve=CURVES[name], word_size=12, glv=bool(glv)),
                                  torch.from_numpy(xw), torch.from_numpy(yw))
        assert np.array_equal(out, twin.numpy()), (name, glv)
