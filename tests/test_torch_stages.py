"""msm_tpu_torch.oracle.stages against msm_tpu.oracle.stages on the same
inputs: each stage model's output equal (digit and index arrays element
for element, points coordinate for coordinate), on BN254 at the
reference tests' sizes and windows; then cuzk_cpu_msm with each bucket
reduction against the port's own oracle MSM."""

import numpy as np
import pytest

from msm_tpu.oracle import stages as JS
from msm_tpu.oracle.pyecc import Curve as JCurve
from msm_tpu.oracle.pyecc import JPoint as JJPoint
from msm_tpu.params import BN254 as J_BN254
from msm_tpu.params import MsmConfig as JConfig
from msm_tpu_torch.oracle import stages as S
from msm_tpu_torch.oracle.pyecc import IDENTITY, Curve
from msm_tpu_torch.params import BN254, MsmConfig

CV, JCV = Curve(BN254), JCurve(J_BN254)


def _j(points):
    """The port's points as the JAX package's JPoints."""
    return [JJPoint(p.x, p.y, p.z) for p in points]


def _same(port_pt, jax_pt) -> bool:
    return (port_pt.x, port_pt.y, port_pt.z) == (jax_pt.x, jax_pt.y, jax_pt.z)


def _scalars(n, seed):
    ks = CV.sample_scalars(n, seed=seed)
    return ks + [0, 1, BN254.order - 1, (1 << 254) - 1, int("aaaa" * 16, 16) % BN254.order, (1 << 253) + 1]


@pytest.mark.parametrize("chunk_size", [4, 13, 16])
def test_decompose_and_transpose_match_reference(chunk_size):
    cfg = MsmConfig(curve=BN254, chunk_size=chunk_size)
    ks = _scalars(13, 5)
    digits = S.decompose_scalars_signed(ks, cfg.num_subtasks, cfg.chunk_size)
    want = JS.decompose_scalars_signed(ks, cfg.num_subtasks, cfg.chunk_size)
    assert digits.dtype == want.dtype and np.array_equal(digits, want)
    for i, k in enumerate(ks):
        assert sum(int(digits[j, i]) << (chunk_size * j) for j in range(cfg.num_subtasks)) == k
    for got, ref in zip(S.cpu_transpose(digits, cfg.num_buckets), JS.cpu_transpose(want, cfg.num_buckets)):
        assert got.dtype == ref.dtype and np.array_equal(got, ref)


def _buckets():
    pts = CV.sample_points(6, seed=8)
    return [IDENTITY, pts[0], IDENTITY, pts[1], pts[2], pts[3], IDENTITY, pts[4], pts[5]]


def test_smvp_matches_reference():
    cfg = MsmConfig(curve=BN254, chunk_size=4)
    pts = CV.sample_points(11, seed=9)
    digits = S.decompose_scalars_signed(_scalars(5, 10), cfg.num_subtasks, cfg.chunk_size)
    col_ptr, val_idxs = S.cpu_transpose(digits, cfg.num_buckets)
    for t in (0, 3, cfg.num_subtasks - 1):
        got = S.cpu_smvp_signed(digits[t], col_ptr[t], val_idxs[t], pts, CV)
        want = JS.cpu_smvp_signed(digits[t], col_ptr[t], val_idxs[t], _j(pts), JCV)
        assert len(got) == len(want) == cfg.num_buckets
        assert all(_same(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("reduction", ["serial", "running_sum", "parallel", "two_phase"])
def test_bucket_reductions_match_reference(reduction):
    b = _buckets()
    if reduction == "two_phase":
        gs, ms = S.parallel_bucket_reduction_1(b, CV, num_threads=2)
        jgs, jms = JS.parallel_bucket_reduction_1(_j(b), JCV, num_threads=2)
        assert all(_same(g, w) for g, w in zip(gs + ms, jgs + jms))
        got = S.parallel_bucket_reduction_2(gs, ms, len(b) - 1, CV)
        want = JS.parallel_bucket_reduction_2(jgs, jms, len(b) - 1, JCV)
    else:
        fn = {"serial": "serial_bucket_reduction", "running_sum": "running_sum_bucket_reduction",
              "parallel": "parallel_bucket_reduction"}[reduction]
        got, want = getattr(S, fn)(b, CV), getattr(JS, fn)(_j(b), JCV)
    assert _same(got, want)
    assert CV.eq(got, S.serial_bucket_reduction(b, CV))


def test_horner_matches_reference():
    ws = CV.sample_points(5, seed=11)
    assert _same(S.horner(ws, 4, CV), JS.horner(_j(ws), 4, JCV))


@pytest.mark.parametrize("variant", ["serial", "running_sum", "parallel", "two_phase"])
def test_cuzk_cpu_msm_matches_reference_and_oracle(variant):
    cfg = MsmConfig(curve=BN254, chunk_size=4)
    pts = CV.sample_points(19, seed=1)
    ks = CV.sample_scalars(15, seed=101) + [0, 1, BN254.order - 1, (1 << 200) + 12345]
    got = S.cuzk_cpu_msm(pts, ks, cfg, bpr_variant=variant, num_threads=4)
    want = JS.cuzk_cpu_msm(_j(pts), ks, JConfig(curve=J_BN254, chunk_size=4), bpr_variant=variant, num_threads=4)
    assert _same(got, want)
    assert CV.eq(got, CV.msm(pts, ks))


def test_cuzk_cpu_msm_production_windows():
    cfg = MsmConfig(curve=BN254, chunk_size=16)
    pts = CV.sample_points(9, seed=2)
    ks = CV.sample_scalars(9, seed=102)
    assert CV.eq(S.cuzk_cpu_msm(pts, ks, cfg, bpr_variant="serial"), CV.msm(pts, ks))


def test_unknown_reduction_raises():
    with pytest.raises(ValueError):
        S.cuzk_cpu_msm(CV.sample_points(2, seed=3), [1, 2], MsmConfig(curve=BN254, chunk_size=4), bpr_variant="x")
