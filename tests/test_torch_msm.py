"""The whole slice on the CPU (run_gpu_msm with device="cpu": every kernel
replaced by its plain twin) against msm_tpu.run_tpu_msm (JAX on the CPU)
and the oracle, at chunk 8 and n = 256. The sort is unstable on both
sides, so the intermediate checks compare bucket-boundary prefixes and
window sums as points, never the per-lane prefixes. The result point's
export is held against the twins' field export."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_helpers import affine_points, mont_limbs, port_cfg, same_points, u16_words_int32
import msm_tpu
import msm_tpu_torch
from msm_tpu.models import common as jcommon
from msm_tpu.models import cuzk as jcuzk
from msm_tpu.models.geometry import pick_geometry as j_pick_geometry
from msm_tpu.ops import scan as jscan
from msm_tpu.ops.curve import get_curve_ctx as j_curve_ctx
from msm_tpu.ops.decompose import decompose_signed as j_decompose
from msm_tpu.oracle import best_msm
from msm_tpu.oracle.pyecc import Curve
from msm_tpu.params import BN254, MsmConfig
from msm_tpu_torch.models import common, cuzk
from msm_tpu_torch.models.geometry import pick_geometry
from msm_tpu_torch.ops import scan
from msm_tpu_torch.ops.cuda_prefix import horner
from msm_tpu_torch.ops.curve import get_curve_ctx
from msm_tpu_torch.ops.decompose import decompose_signed
from msm_tpu_torch.ops.field import FieldCtx
from msm_tpu_torch.utils.limbs import limbs_to_int

JCFG = MsmConfig(curve=BN254, chunk_size=8)
CFG = port_cfg(JCFG)
CV = Curve(BN254)


def _inputs(n, seed):
    base = affine_points(CFG, 64, seed=seed)
    pts = [base[i % 64] for i in range(n)]
    rng = np.random.default_rng(seed)
    ks = [int.from_bytes(rng.bytes(32), "little") % BN254.order for _ in range(n)]
    return pts, ks


def test_slice_matches_jax_and_oracle():
    n = 256
    pts, ks = _inputs(n, seed=41)
    got = msm_tpu_torch.run_gpu_msm(pts, ks, config=CFG, device="cpu")
    want = CV.to_affine(best_msm(pts, ks))
    assert got == want
    assert msm_tpu.run_tpu_msm(pts, ks, config=JCFG) == want

    # window sums [S, 3, L]: the port's vs the JAX pipeline's, as points
    x_u16, y_u16, s_u16 = common.pad_inputs(pts, ks, CFG)
    packed = common.prepare_points(CFG, torch.from_numpy(x_u16), torch.from_numpy(y_u16))
    ws = cuzk.window_sums_from_table(packed, torch.from_numpy(s_u16), CFG, pick_geometry(n, CFG))
    ws_std = common.export_points_std(get_curve_ctx(CFG), scan.PointBatch(*ws.unbind(1))).numpy()
    j_ws = np.asarray(jcuzk.cuzk_window_sums(
        *map(jnp.asarray, u16_words_int32(x_u16, y_u16)), jnp.asarray(s_u16), JCFG, j_pick_geometry(n, 8)))
    assert same_points([ws_std[:, i] for i in range(3)], [j_ws[:, i] for i in range(3)], CFG)
    # host Horner over the port's window sums gives the MSM as well
    assert CV.to_affine(common.window_sums_to_result(ws_std, CFG)) == want


def test_boundary_prefixes_match_jax():
    """Bucket-boundary prefixes of two subtasks against the JAX
    bucket_boundary_prefix (XLA path) on the same points and keys."""
    n, R = 256, 32
    pts, ks = _inputs(n, seed=43)
    x_u16, y_u16, s_u16 = common.pad_inputs(pts, ks, CFG)
    keys, signs = decompose_signed(torch.from_numpy(s_u16), 8, CFG.num_subtasks)
    packed = common.prepare_points(CFG, torch.from_numpy(x_u16), torch.from_numpy(y_u16))
    got = scan.bucket_boundary_prefix(get_curve_ctx(CFG), packed, keys[:2], signs[:2],
                                      CFG.num_buckets, R, batch=2)

    jec = j_curve_ctx(JCFG)
    jpts = jcommon.u16_to_mont_points(jec, *map(jnp.asarray, u16_words_int32(x_u16, y_u16)))
    jk, js = j_decompose(jnp.asarray(s_u16), 8, CFG.num_subtasks)

    @functools.partial(jax.jit, static_argnums=(2,))
    def bbp(k, s, sub):
        return jscan.bucket_boundary_prefix(jec, jpts, k, CFG.num_buckets, R, signs=s,
                                            affine=True)

    for sub in range(2):
        want = bbp(jk[sub], js[sub], sub)
        assert same_points([np.asarray(w) for w in want], [g[sub].numpy() for g in got], CFG)


def test_empty_msm():
    assert msm_tpu_torch.run_gpu_msm([], [], device="cpu") is None


def test_result_export_in_exact_integers(monkeypatch):
    """msm_point_from_ws's export of the Horner point (the twin's balanced
    limbs, from real window sums in random projective form, one the
    identity) gives exactly the standard-form triple of the twins' field
    export (from_mont, canonical) of that point, and runs no field op after
    the Horner kernel."""
    rng = np.random.default_rng(47)
    S, p = CFG.num_subtasks, BN254.modulus
    base = affine_points(CFG, 8, seed=47)
    zs = [int(v) for v in rng.integers(1, 1 << 62, size=S)]
    x, y = ([base[i % 8][k] * z % p for i, z in enumerate(zs)] for k in range(2))
    x[3], zs[3] = 0, 0
    ws = torch.from_numpy(np.stack([mont_limbs(v, CFG) for v in (x, y, zs)], axis=1))  # [S, 3, L]
    h = horner(CFG, ws[:, 0], ws[:, 1], ws[:, 2], CFG.chunk_size)
    old = common.export_points_std(get_curve_ctx(CFG), scan.PointBatch(*(c[None] for c in h)))[0]
    want = tuple(limbs_to_int(old[i].numpy(), CFG.word_size) for i in range(3))

    def no_field_op(*args, **kwargs):
        raise AssertionError("a field op ran on the result's export")

    def horner_then_no_field_ops(cfg, wx, wy, wz, chunk):
        assert cfg == CFG and chunk == CFG.chunk_size and torch.equal(wx, ws[:, 0])
        for name in ("from_mont", "canonical", "mont_mul", "add", "sub", "neg"):
            monkeypatch.setattr(FieldCtx, name, no_field_op)
        return h

    monkeypatch.setattr(cuzk, "horner", horner_then_no_field_ops)
    got = cuzk.msm_point_from_ws(ws, CFG)
    monkeypatch.undo()
    assert got == want and all(0 <= v < p for v in got)
    assert common.std_ints_to_jpoint(*got, CFG) == common.std_point_to_jpoint(old.numpy(), CFG)
