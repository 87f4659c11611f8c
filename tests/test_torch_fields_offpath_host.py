"""Kernel 8's chain body (bpr.cuh bpr_phase1_chain, a group of 4 lanes run
by one thread on the host) and the scaled convert's per-point body
(convert32.cuh convert_point_scaled, all three layouts) on the generic
word core, compiled for the host with g++ (``_build.FIELD_FLAGS``) for all
seven fields and held against their plain PyTorch twins of the same curve:

- BPR phase 1 over G = 2 subtasks of T = 8 lanes and Bl = 4 steps of
  random field triples (the kernel adds in its twin's order, so no curve
  points are needed), y negated in balanced limbs on every fourth lane, the
  identity at the second step of lane 3 and the first bucket repeated at
  the second step of lane 5 (acc + m and m + B then add a point to itself):
  m and g exactly, after canonical();
- the scaled convert in its five modes (an override of the x constant, two
  tables, the triple table with an override, the plain default, the
  triple table with the GLV constants) on 58 real points and six edge
  words (values >= p, the largest the curve's words hold), against
  convert_pack_scaled_plain, the tables bit for bit."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_helpers import affine_points, mont_limbs
from msm_tpu_torch.models.common import ints_to_u16_array
from msm_tpu_torch.ops._build import FIELD_FLAGS, curve_id
from msm_tpu_torch.ops.cuda_bpr import bpr_phase1_plain
from msm_tpu_torch.ops.cuda_convert import CONVERT_DUAL, CONVERT_ONE, CONVERT_TRIPLE, convert_pack_scaled_plain, coord_u16
from msm_tpu_torch.ops.field import get_field_ctx
from msm_tpu_torch.ops.glv import glv_params
from msm_tpu_torch.params import CURVES, MsmConfig, coord_words

CSRC = Path(__file__).resolve().parent.parent / "msm_tpu_torch" / "csrc"

HARNESS = r"""
#include "bpr.cuh"
#include "convert32.cuh"
using namespace msm;

template <class F>
struct Bpr {  // b* [G, Bl, T, L]; m*, g* [G, T, L]
  static void run(const int32_t* bx, const int32_t* by, const int32_t* bz,
                  int32_t* mx, int32_t* my, int32_t* mz, int32_t* gx,
                  int32_t* gy, int32_t* gz, int64_t G, int Bl, int T) {
    for (int64_t g = 0; g < G; ++g)
      for (int t = 0; t < T; ++t)
        bpr_phase1_chain<4, F>(bx, by, bz, mx, my, mz, gx, gy, gz, g, Bl, T, t,
                               true);
  }
};

template <class F>
struct ConvertScaled {  // the x constants as NW words each
  static void run(const int16_t* xw, const int16_t* yw, const uint32_t* xs,
                  const uint32_t* xs2, int32_t* out, int32_t* out2, int64_t n,
                  int layout) {
    fe32t<F> a, b;
    for (int k = 0; k < F::NW; ++k) {
      a.w[k] = xs[k];
      b.w[k] = xs2[k];
    }
    for (int64_t i = 0; i < n; ++i) {
      if (layout == CONVERT_ONE)
        convert_point_scaled<CONVERT_ONE, F>(xw, yw, a, b, out, out2, i);
      else if (layout == CONVERT_DUAL)
        convert_point_scaled<CONVERT_DUAL, F>(xw, yw, a, b, out, out2, i);
      else
        convert_point_scaled<CONVERT_TRIPLE, F>(xw, yw, a, b, out, out2, i);
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
void h_bpr(int c, I bx, I by, I bz, O mx, O my, O mz, O gx, O gy, O gz, int64_t G,
           int Bl, int T) {
  dispatch<Bpr>(c, bx, by, bz, mx, my, mz, gx, gy, gz, G, Bl, T);
}
void h_convert_scaled(int c, const int16_t* xw, const int16_t* yw,
                      const uint32_t* xs, const uint32_t* xs2, O out, O out2,
                      int64_t n, int layout) {
  dispatch<ConvertScaled>(c, xw, yw, xs, xs2, out, out2, n, layout);
}
}
"""

NAMES = list(CURVES)
P_, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available")
    d = tmp_path_factory.mktemp("fields_offpath_host")
    src, so = d / "harness.cpp", d / "harness.so"
    src.write_text(HARNESS)
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC", *FIELD_FLAGS, f"-I{CSRC}", "-o", str(so),
                    str(src)], check=True, capture_output=True, text=True, timeout=600)
    lib = ctypes.CDLL(str(so))
    lib.h_bpr.argtypes = [I32] + [P_] * 9 + [I64, I32, I32]
    lib.h_convert_scaled.argtypes = [I32] + [P_] * 6 + [I64, I32]
    lib.h_bpr.restype = lib.h_convert_scaled.restype = None
    return lib


def _rand_fe(rng, shape, cfg) -> np.ndarray:
    """Field elements below p as int32 limbs: the modulus' highest nonzero
    limb k drawn below its value, the limbs above it 0."""
    w = cfg.word_size
    k = (cfg.curve.modulus_bits - 1) // w
    a = rng.integers(0, 1 << w, size=shape + (cfg.num_words,))
    a[..., k] = rng.integers(0, cfg.curve.modulus >> (w * k), size=shape)
    a[..., k + 1:] = 0
    return a.astype(np.int32)


@pytest.mark.parametrize("name", NAMES)
def test_bpr_phase1_body_matches_twin(lib, name):
    cfg = MsmConfig(curve=CURVES[name])
    G, Bl, T, L = 2, 4, 8, cfg.num_words
    rng = np.random.default_rng(210 + NAMES.index(name))
    b = [_rand_fe(rng, (G, Bl, T), cfg) for _ in range(3)]
    b[1][:, :, ::4] *= -1  # balanced limbs
    for c, v in zip(b, (0, mont_limbs([1], cfg)[0], 0)):  # the identity
        c[:, Bl - 2, 3] = v
    for c in b:  # the first bucket again: m + B adds a point to itself
        c[:, Bl - 2, 5] = c[:, Bl - 1, 5]
    outs = [np.zeros((G, T, L), dtype=np.int32) for _ in range(6)]
    lib.h_bpr(curve_id(cfg), *(a.ctypes.data for a in b), *(o.ctypes.data for o in outs), G, Bl, T)
    want = bpr_phase1_plain(cfg, *map(torch.from_numpy, b))
    f = get_field_ctx(cfg)
    for got, w in zip(outs, want):
        assert got.min() >= 0 and got.max() < (1 << cfg.word_size)
        assert np.array_equal(got, f.canonical(w).numpy())


def _words32(v: int, nw: int) -> np.ndarray:
    return np.array([(v >> (32 * k)) & 0xFFFFFFFF for k in range(nw)], dtype=np.uint32)


@pytest.mark.parametrize("mode", ["override", "dual", "triple_override", "default", "triple"])
@pytest.mark.parametrize("name", NAMES)
def test_convert_scaled_body_matches_twin(lib, name, mode):
    cfg = MsmConfig(curve=CURVES[name])
    p, wu, D = cfg.curve.modulus, coord_u16(cfg), coord_words(cfg)
    top = (1 << (16 * wu)) - 1
    aff = affine_points(cfg, 58, seed=220) + [(0, 2), (1, 1), (p - 1, 5), (p, p + 1), (min(2 * p - 1, top), top),
                                              (top, 3)]
    xw, yw = (ints_to_u16_array([c[i] for c in aff], 2 * wu).view(np.int16) for i in range(2))
    n = len(aff)
    s1 = (0x1234_5678_9ABC_DEF0 * cfg.r2 % p) if mode in ("override", "triple_override") else None
    s2 = glv_params(cfg.curve).beta * cfg.r2 % p if mode in ("dual", "triple_override", "triple") else None
    layout = {"dual": CONVERT_DUAL, "triple_override": CONVERT_TRIPLE, "triple": CONVERT_TRIPLE}.get(mode, CONVERT_ONE)
    out = np.zeros((n, (3 if layout == CONVERT_TRIPLE else 2) * D), dtype=np.int32)
    out2 = np.zeros((n, 2 * D), dtype=np.int32)
    c1, c2 = _words32(cfg.r2 % p if s1 is None else s1, D), _words32(s2 or 0, D)
    lib.h_convert_scaled(curve_id(cfg), xw.ctypes.data, yw.ctypes.data, c1.ctypes.data, c2.ctypes.data,
                         out.ctypes.data, out2.ctypes.data, n, layout)
    want = convert_pack_scaled_plain(cfg, torch.from_numpy(xw), torch.from_numpy(yw), x_scale=s1, dual_x_scale=s2,
                                     triple=layout == CONVERT_TRIPLE)
    if layout == CONVERT_DUAL:
        assert np.array_equal(out, want[0].numpy()) and np.array_equal(out2, want[1].numpy())
    else:
        assert np.array_equal(out, want.numpy()) and not out2.any()
