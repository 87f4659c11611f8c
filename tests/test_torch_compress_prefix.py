"""The machinery around the pair-compressed scan, on the CPU (plain twins):

- compressed bucket-boundary prefixes equal the plain ones as points, on
  keys with odd and even boundaries and empty buckets;
- the gate: a geometry with an odd step count (C = 1) runs uncompressed;
- GLV with compression runs on the CPU; off the CPU compress_pairs under
  GLV goes through the GLV modes of its kernels;
- the JAX package's point table, carried across, gives its window sums
  under the compressed config;
- only one subtask batch of prefixes is alive at a time, on both the plain
  and the compressed branch."""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import affine_points, port_cfg, same_points
import msm_tpu_torch
from msm_tpu.models import common as jcommon
from msm_tpu.models import cuzk as jcuzk
from msm_tpu.models.geometry import pick_geometry as j_pick_geometry
from msm_tpu.ops.curve import get_curve_ctx as j_curve_ctx
from msm_tpu.ops.pallas_convert import make_convert_pack
from msm_tpu.oracle import best_msm
from msm_tpu.oracle.pyecc import Curve
from msm_tpu.params import BN254
from msm_tpu.params import MsmConfig as JMsmConfig
from msm_tpu_torch.models import common, cuzk
from msm_tpu_torch.models.geometry import pick_geometry
from msm_tpu_torch.ops import scan
from msm_tpu_torch.ops.cuda_compress import compress_pairs
from msm_tpu_torch.ops.curve import get_curve_ctx
from msm_tpu_torch.ops.decompose import decompose_signed

JCFG = JMsmConfig(curve=BN254, chunk_size=8, compress=True)
CFG = port_cfg(JCFG)
PLAIN = port_cfg(JMsmConfig(curve=BN254, chunk_size=8))
CV = Curve(BN254)


def _inputs(n, seed, nbase=64):
    base = affine_points(CFG, nbase, seed=seed)
    pts = [base[i % nbase] for i in range(n)]
    rng = np.random.default_rng(seed)
    ks = [int.from_bytes(rng.bytes(32), "little") % BN254.order for _ in range(n)]
    return pts, ks


def _keys_and_table(n, seed):
    pts, ks = _inputs(n, seed=seed)
    x_u16, y_u16, s_u16 = common.pad_inputs(pts, ks, CFG)
    packed = common.prepare_points(CFG, torch.from_numpy(x_u16), torch.from_numpy(y_u16))
    keys, signs = decompose_signed(torch.from_numpy(s_u16), 8, CFG.num_subtasks)
    return packed, keys, signs


def test_compressed_boundary_prefixes_match_plain():
    """Three subtasks at n = 256, R = 16 (C = 16 steps): the boundaries
    fall on odd and even steps, and some of the 129 buckets are empty."""
    n, R = 256, 16
    packed, keys, signs = _keys_and_table(n, seed=93)
    keys, signs = keys[:3], signs[:3]
    assert scan.compression_applies(CFG, n, R)
    ends = scan._counts_leq(CFG, keys, CFG.num_buckets)
    c = (ends - 1) % (n // R)
    assert (c % 2 == 0).any() and (c % 2 == 1).any()
    assert (torch.diff(ends, dim=-1) == 0).any()  # empty buckets
    got = scan.bucket_boundary_prefix(get_curve_ctx(CFG), packed, keys, signs,
                                      CFG.num_buckets, R, batch=2)
    want = scan.bucket_boundary_prefix(get_curve_ctx(PLAIN), packed, keys, signs,
                                       PLAIN.num_buckets, R, batch=2)
    assert same_points([a.numpy() for a in got], [a.numpy() for a in want], CFG)


def _recording(monkeypatch):
    """Wrap both scans of ``ops/scan`` to record which ran and to assert,
    at each call, that no earlier batch's pe3 is still alive."""
    calls, alive = [], []

    def wrap(name, fn):
        def run(*args):
            gc.collect()
            assert all(ref() is None for ref in alive), "an earlier batch's pe3 is alive"
            out = fn(*args)
            calls.append(name)
            alive.append(weakref.ref(out[0]))
            return out
        monkeypatch.setattr(scan, name, run)

    wrap("scan_rows", scan.scan_rows)
    wrap("compressed_prefix_scan", scan.compressed_prefix_scan)
    return calls


@pytest.mark.parametrize("cfg", [PLAIN, CFG], ids=["plain", "compressed"])
def test_one_batch_alive(monkeypatch, cfg):
    n, R = 64, 8
    packed, keys, signs = _keys_and_table(n, seed=94)
    calls = _recording(monkeypatch)
    scan.bucket_boundary_prefix(get_curve_ctx(cfg), packed, keys[:3], signs[:3],
                                cfg.num_buckets, R, batch=1)
    want = "compressed_prefix_scan" if cfg.compress else "scan_rows"
    assert calls == [want] * 3


def test_gate_odd_steps_run_uncompressed(monkeypatch):
    """R = n leaves one step per lane (C = 1): no pairs, the plain scan."""
    n = 32
    pts, ks = _inputs(n, seed=95)
    assert not scan.compression_applies(CFG, n, n)
    calls = _recording(monkeypatch)
    got = cuzk.compute_msm(pts, ks, config=CFG, geometry=cuzk.MsmGeometry(n, 1, 8), device="cpu")
    assert got == CV.to_affine(best_msm(pts, ks))
    assert set(calls) == {"scan_rows"}


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_glv_with_compression_raises(device, monkeypatch):
    """Compression with GLV runs: on the CPU the MSM equals the oracle.
    Nothing raises for GLV off the CPU any more: there (here on the meta
    device, with the launches recorded instead of made) compress_pairs
    launches the GLV modes of kernels 10 and 11 around kernel 9, and only
    those, each counted."""
    from msm_tpu_torch.ops import _build, cuda_compress, cuda_inv

    cfg = port_cfg(JMsmConfig(curve=BN254, chunk_size=8, compress=True, glv=True))
    if device == "cpu":
        pts, ks = _inputs(16, seed=96)
        got = msm_tpu_torch.run_gpu_msm(pts, ks, config=cfg, device=device)
        assert got == CV.to_affine(best_msm(pts, ks))
        return
    entries = []
    monkeypatch.setattr(_build, "require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(_build, "launch", lambda name, *args, width: entries.append(name) if width == 13 else None)
    wrappers = (cuda_compress.pair_forward, cuda_compress.pair_forward_glv, cuda_inv.mont_pow,
                cuda_compress.pair_backward, cuda_compress.pair_backward_glv)
    for w in wrappers:
        monkeypatch.setattr(w, "launches", 0)
    table = torch.empty((16, 24), dtype=torch.int32, device="meta")
    perm = torch.empty((1, 8, 2), dtype=torch.int32, device="meta")
    cx, cy, inf = compress_pairs(cfg, table, perm, perm)
    assert entries == ["msm_pair_forward_glv", "msm_mont_pow", "msm_pair_backward_glv"]
    assert [w.launches for w in wrappers] == [0, 1, 1, 0, 1]
    assert cx.shape == cy.shape == (1, 4, cfg.num_words, 2) and inf.shape == (1, 4, 2)


def test_loaded_jax_table_gives_jax_window_sums_compressed():
    n = 256
    pts, ks = _inputs(n, seed=97, nbase=32)
    x_u16, y_u16, s_u16 = jcommon.pad_inputs(pts, ks, JCFG)
    xd, yd, sd = map(jnp.asarray, (x_u16, y_u16, s_u16))
    jax_table = np.asarray(make_convert_pack(JCFG, tile=128, interpret=True)(xd, yd))
    table = msm_tpu_torch.load_point_table(jax_table, CFG, device="cpu")
    ws = cuzk.window_sums_from_table(table, torch.from_numpy(s_u16), CFG,
                                     pick_geometry(n, CFG))

    jec = j_curve_ctx(JCFG)
    jgeom = j_pick_geometry(n, 8, compress=True)
    want = np.asarray(jax.jit(lambda x, y, s: jcuzk.window_sums_from_table(
        jcommon.u16_to_mont_points(jec, x, y), None, s, JCFG, jgeom))(xd, yd, sd))
    assert same_points([want[:, i] for i in range(3)], [ws[:, i].numpy() for i in range(3)], CFG)
