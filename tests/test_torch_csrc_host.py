"""The CUDA core (msm_tpu_torch/csrc/field.cuh, curve.cuh) compiled for the
host with g++ and held against the plain PyTorch twins on random inputs:
Montgomery product, balanced-input canonicalization, complete addition,
mixed addition and doubling. Catches arithmetic faults in the device core
without a GPU. Outputs of the core must be canonical and equal to the
twins' results after canonical()."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_helpers import rand_balanced, rand_canonical
from msm_tpu.params import BN254, MsmConfig
from msm_tpu_torch.ops.cuda_curve import b3_mont_limbs, point_add_plain
from msm_tpu_torch.ops.cuda_scan import rcb16_madd_plain
from msm_tpu_torch.ops.curve import CurveCtx, PointBatch
from msm_tpu_torch.ops.field import get_field_ctx

CSRC = Path(__file__).resolve().parent.parent / "msm_tpu_torch" / "csrc"
CFG = MsmConfig(curve=BN254)
F = get_field_ctx(CFG)
L = CFG.num_words

HARNESS = r"""
#include "curve.cuh"
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
        [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", f"-I{CSRC}", "-o", str(so), str(src)],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(so))
    P = ctypes.c_void_p
    for name, nargs in (("h_fe_mul", 3), ("h_from_balanced", 2), ("h_pt_add", 3),
                        ("h_pt_madd", 3), ("h_pt_double", 2)):
        fn = getattr(lib, name)
        fn.argtypes = [P] * nargs + [ctypes.c_int64]
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
