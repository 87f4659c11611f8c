"""The word-core bodies of the point add (kernel 1, csrc/point_add.cuh) and
the point total (kernel 6, csrc/point_total.cuh) compiled for the host with
g++ and held against the plain PyTorch twins. The point add's two bodies (a
thread per add, a warp per add) run for every row of a batch with balanced,
canonical, negated-y, identity, P + P and P + (-P) rows.
The point total runs as a model of its two launches: every thread's run of
points, the block's fold (the upper warps' sums through shared memory, then
warp 0's shuffle tree: at offset h lane l adds lane l + h's sum, as
__shfl_down_sync gives it), the partials in words and the finishing warp's
tree over the lanes that hold a partial, on real curve points at small
(G, N), with N not a multiple of a run, N below one run, several blocks
and more partials than lanes. It sums in another order than its
twin, so those results compare as points."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_helpers import affine_points, mont_limbs, rand_balanced, same_points
from msm_tpu_torch.ops._build import FIELD_FLAGS
from msm_tpu_torch.ops.cuda_curve import point_add_plain
from msm_tpu_torch.ops.cuda_prefix import THREADS, point_total_plain, pt_words
from msm_tpu_torch.ops.field import get_field_ctx
from msm_tpu_torch.params import BN254, MsmConfig

CSRC = Path(__file__).resolve().parent.parent / "msm_tpu_torch" / "csrc"
CFG = MsmConfig(curve=BN254)
F = get_field_ctx(CFG)
L = CFG.num_words
P = BN254.modulus

HARNESS = r"""
#include <vector>

#include "point_total.cuh"
using namespace msm;

constexpr int BLOCK = %(threads)d;
static_assert(pt_words<FpBn254> == %(pt_words)d, "ops/cuda_prefix.py pt_words");

// __shfl_down_sync's halving tree over v[0 .. width): at offset h, lane
// l < h adds lane l + h's sum (csrc/point_total.cu pt32_lanes_sum; the
// lanes >= h compute sums that never reach lane 0).
static void lanes_sum(pt32* v, int width) {
  for (int h = width / 2; h > 0; h >>= 1)
    for (int l = 0; l < h; ++l) pt32_add(v[l], v[l], v[l + h]);
}

extern "C" {
void w_point_add(const int32_t* ax, const int32_t* ay, const int32_t* az,
                 const int32_t* bx, const int32_t* by, const int32_t* bz,
                 int32_t* ox, int32_t* oy, int32_t* oz, int64_t n, int lanes) {
  for (int64_t i = 0; i < n; ++i)
    if (lanes)
      point_add_row_lanes(ax, ay, az, bx, by, bz, ox, oy, oz, i);
    else
      point_add_row(ax, ay, az, bx, by, bz, ox, oy, oz, i);
}
// k_point_total over grid (nb, G), then k_point_total_finish over G warps
void w_point_total(const int32_t* px, const int32_t* py, const int32_t* pz,
                   uint32_t* part, int32_t* ox, int32_t* oy, int32_t* oz,
                   int64_t G, int64_t N, int k, int nb) {
  for (int64_t g = 0; g < G; ++g) {
    for (int64_t b = 0; b < nb; ++b) {
      std::vector<pt32> s(BLOCK);
      for (int t = 0; t < BLOCK; ++t)
        pt_total_run(s[t], px, py, pz, g, N, k, b * BLOCK + t);
      for (int h = BLOCK / 2; h >= 32; h >>= 1)  // through shared memory
        for (int t = 0; t < h; ++t) pt32_add(s[t], s[t], s[t + h]);
      lanes_sum(s.data(), 32);
      pt32_store_words(part + (g * nb + b) * pt_words<FpBn254>, s[0]);
    }
    std::vector<pt32> s(32);
    for (int lane = 0; lane < 32; ++lane)
      pt_total_partials(s[lane], part, g, nb, lane, 32);
    int width = 1;
    while (width < nb && width < 32) width <<= 1;
    lanes_sum(s.data(), width);
    pt32_store_limbs(ox + g * L, oy + g * L, oz + g * L, 1, s[0]);
  }
}
}
""" % {"threads": THREADS, "pt_words": pt_words(CFG)}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available")
    d = tmp_path_factory.mktemp("words_host")
    src = d / "harness.cpp"
    src.write_text(HARNESS)
    so = d / "harness.so"
    subprocess.run(
        [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", *FIELD_FLAGS, f"-I{CSRC}", "-o", str(so), str(src)],
        check=True, capture_output=True, text=True, timeout=600,
    )
    lib = ctypes.CDLL(str(so))
    Pt, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for name, argtypes in (("w_point_add", [Pt] * 9 + [I64, I32]),
                           ("w_point_total", [Pt] * 7 + [I64, I64, I32, I32])):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None
    return lib


def _assert_canonical_equal(got, twin):
    """got: canonical limbs from the core; twin: any representation (torch)."""
    assert got.min() >= 0 and got.max() < (1 << CFG.word_size)
    assert np.array_equal(got, F.canonical(twin).numpy())


@pytest.mark.parametrize("lanes", [0, 1], ids=["thread", "warp"])
def test_point_add_rows_match_twin(lib, lanes):
    """Kernel 1's bodies (a thread per add; a warp per add, its products
    split over the lanes, computed here by one thread) on random balanced
    rows (any field elements: the formula is algebraic), canonical rows,
    rows with y negated, the identity on either side, P + P and P + (-P)."""
    rng = np.random.default_rng(61)
    n = 96
    a = [rand_balanced(rng, (n,), CFG) for _ in range(3)]
    b = [rand_balanced(rng, (n,), CFG) for _ in range(3)]
    a[1][::4] *= -1
    b[1][1::4] *= -1
    for pt in (a, b):  # canonical rows, as the kernels write them
        for c in pt:
            c[24:40] = F.canonical(torch.from_numpy(c[24:40])).numpy()
    one = mont_limbs([1], CFG)[0]
    for pt, rows in ((a, slice(0, 4)), (b, slice(4, 8))):  # identities (0 : 1 : 0)
        pt[0][rows], pt[1][rows], pt[2][rows] = 0, one, 0
    for i in range(3):
        b[i][8:16] = a[i][8:16]  # P + P
        b[i][16:24] = -a[i][16:24] if i == 1 else a[i][16:24]  # P + (-P)
    ins = [np.ascontiguousarray(t) for t in a + b]
    outs = [np.zeros((n, L), dtype=np.int32) for _ in range(3)]
    lib.w_point_add(*(t.ctypes.data for t in ins), *(o.ctypes.data for o in outs), n, lanes)
    want = point_add_plain(CFG, *map(torch.from_numpy, ins))
    for g, w in zip(outs, want):
        _assert_canonical_equal(g, w)
    assert not F.canonical(torch.from_numpy(outs[2][16:24])).any()  # P + (-P) = identity


def _curve_points(G, N, seed):
    """[G, N, L] x3 real curve points in random projective form (X z, Y z,
    z), Montgomery limbs, with some identities and some negated points."""
    rng = np.random.default_rng(seed)
    base = affine_points(CFG, 24, seed=seed)
    idx = rng.integers(0, len(base), size=G * N)
    zs = [int(v) for v in rng.integers(1, 1 << 62, size=G * N)]
    xs = [base[i][0] * z % P for i, z in zip(idx, zs)]
    ys = [(base[i][1] if k % 5 else P - base[i][1]) * z % P for k, (i, z) in enumerate(zip(idx, zs))]
    for k in range(0, G * N, 7):  # identities (0 : z : 0)
        xs[k], zs[k] = 0, 0
    return [mont_limbs(v, CFG).reshape(G, N, L) for v in (xs, ys, zs)]


@pytest.mark.parametrize("G, N, k, nb", [
    (2, 37, 3, 1),  # 12 full runs of 3 and one of 1
    (3, 2, 4, 1),  # N below one run
    (1, 300, 1, 3),  # three blocks, the last partly empty; a 2-level finish
    (2, 600, 2, 3),  # runs of 2 over three blocks
    (1, 4500, 1, 36),  # 36 partials: lanes 0-3 of the finishing warp sum two
])
def test_point_total_model_matches_twin(lib, G, N, k, nb):
    """Kernel 6's two launches, modelled over its per-thread bodies, on
    real points against point_total_plain, as points."""
    assert nb * THREADS * k >= N > (nb - 1) * THREADS * k  # the kernel's plan check
    pts = _curve_points(G, N, seed=62 + N)
    part = np.zeros((G, nb, pt_words(CFG)), dtype=np.uint32)
    outs = [np.zeros((G, L), dtype=np.int32) for _ in range(3)]
    lib.w_point_total(*(p.ctypes.data for p in pts), part.ctypes.data,
                      *(o.ctypes.data for o in outs), G, N, k, nb)
    for o in outs:
        assert o.min() >= 0 and o.max() < (1 << CFG.word_size)
    want = point_total_plain(CFG, *map(torch.from_numpy, pts))
    assert same_points(outs, [w.numpy() for w in want], CFG)
