"""The slice on the CPU against the oracle: the production window size
(pick_config, c = 13) at n = 2^12, and the edge inputs — scalars 0, 1,
order - 1 and out of range, n not a power of two, duplicate points, an
identity result, and the validation of off-curve points and, on
BLS12-381, of points outside the order-r subgroup."""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_helpers import affine_points
from test_torch_subgroup import check_validate
import msm_tpu_torch
from msm_tpu.oracle import best_msm
from msm_tpu.oracle.pyecc import Curve
from msm_tpu.ops.pallas_curve import karatsuba_ok as j_karatsuba_ok
from msm_tpu.params import BN254 as J_BN254
from msm_tpu.params import CURVES as J_CURVES
from msm_tpu.params import MsmConfig as J_MsmConfig
from msm_tpu_torch.ops._build import check_cuda_config, require_cuda
from msm_tpu_torch.params import BLS12_377, BLS12_381, BN254, GRUMPKIN, PALLAS, MsmConfig, pick_config

CFG8 = MsmConfig(curve=BN254, chunk_size=8)
CV = Curve(J_BN254)
R = BN254.order


def test_pick_config_n4096_matches_oracle():
    n = 1 << 12
    cfg = pick_config(n)
    assert cfg.chunk_size == 13 and cfg.num_subtasks == 20
    base = affine_points(cfg, 64, seed=51)
    pts = [base[i % 64] for i in range(n)]
    rng = np.random.default_rng(51)
    ks = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
    got = msm_tpu_torch.run_gpu_msm(pts, ks, device="cpu")
    assert got == CV.to_affine(best_msm(pts, ks))


def test_edge_scalars_duplicates_and_padding():
    """n = 35 (padded to 64 with the generator), repeated points, and
    scalars at the window-recode edges and outside [0, order)."""
    base = affine_points(CFG8, 12, seed=52)
    pts = [base[i % 12] for i in range(35)]
    rng = np.random.default_rng(52)
    ks = [0, 1, R - 1, R, R + 5, 2 * R - 1, (1 << 256) - 1, -3, (1 << 253) + 1]
    ks += [int(v) for v in rng.integers(0, 1 << 62, size=35 - len(ks))]
    got = msm_tpu_torch.run_gpu_msm(pts, ks, config=CFG8, device="cpu")
    assert got == CV.to_affine(best_msm(pts, [k % R for k in ks]))


def test_identity_result_and_validation():
    p0, p1 = affine_points(CFG8, 2, seed=53)
    # k*P + (order-k)*P + 0*Q is the identity
    assert msm_tpu_torch.run_gpu_msm([p0, p0, p1], [5, R - 5, 0], config=CFG8,
                                     device="cpu") is None
    with pytest.raises(ValueError, match="not on the curve"):
        msm_tpu_torch.run_gpu_msm([p0, (p1[0], p1[1] + 1)], [1, 2], config=CFG8,
                                  validate=True, device="cpu")
    # BLS12-381 (cofactor > 1): subgroup points pass, a point outside the
    # subgroup raises at its index
    check_validate("bls12_381", "run_gpu_msm")


#: config changes the CUDA kernels take (True) or refuse (False)
CONFIG_CASES = {
    "curve": ({"curve": BLS12_381}, True),
    "word_size": ({"word_size": 16}, False),
    "glv": ({"glv": True}, True),
    "compress": ({"compress": True, "glv": True}, True),
    "karatsuba": ({"karatsuba": True}, True),
    "other_curve_compress": ({"curve": BLS12_381, "compress": True}, True),
    "other_curve_glv": ({"curve": BLS12_381, "glv": True}, True),
    "other_curve_glv_compress": ({"curve": GRUMPKIN, "compress": True, "glv": True}, True),
    "other_curve_word_size": ({"curve": GRUMPKIN, "word_size": 12}, True),
    "word_size_12": ({"word_size": 12}, True),
    "other_curve_word_size_12_glv_compress": ({"curve": BLS12_381, "word_size": 12, "compress": True, "glv": True},
                                              True),
    "word_size_11": ({"word_size": 11}, False),
    "word_size_8": ({"word_size": 8}, False),
    "karatsuba_word_size_12": ({"word_size": 12, "karatsuba": True}, True),
    "karatsuba_bls12_377_word_size_12": ({"curve": BLS12_377, "word_size": 12, "karatsuba": True}, True),
    "karatsuba_bls12_381_word_size_12": ({"curve": BLS12_381, "word_size": 12, "karatsuba": True}, False),
    "karatsuba_odd_limbs": ({"curve": PALLAS, "karatsuba": True}, False),
    "karatsuba_bls12": ({"curve": BLS12_381, "karatsuba": True}, True),
    "karatsuba_word_size": ({"word_size": 14, "karatsuba": True}, False),
}


@pytest.mark.parametrize("change, accepted", CONFIG_CASES.values(), ids=CONFIG_CASES)
def test_cuda_kernels_reject_other_configs(change, accepted):
    """The CUDA wrappers take 13- and 12-bit limbs on every curve, plain or
    pair-compressed, with or without GLV; Karatsuba where the JAX package
    builds it (an even limb count within its int32 column budget: at 13
    bits BN254 and BLS12, not the 21-limb curves; at 12 bits every curve
    but BLS12-381's 33 limbs); any other config (another limb width, named
    in the refusal, or Karatsuba where the JAX package refuses it) raises
    before a launch, never falls back to a twin."""
    check_cuda_config(pick_config(1 << 16))
    check_cuda_config(dataclasses.replace(pick_config(1 << 16), compress=True))
    cfg = dataclasses.replace(pick_config(1 << 16), **change)
    if cfg.karatsuba:  # the JAX package's own rule agrees
        assert j_karatsuba_ok(J_MsmConfig(curve=J_CURVES[cfg.curve.name], word_size=cfg.word_size,
                                          karatsuba=True)) is accepted
    if accepted:
        check_cuda_config(cfg)
        return
    with pytest.raises(NotImplementedError, match=f"word_size[ =]{cfg.word_size}"):
        check_cuda_config(cfg)


@pytest.mark.parametrize("width", [13, 12])
def test_a_width_builds_and_loads_only_its_library(monkeypatch, width):
    """A config's launches go to the library of its word_size: the wrappers
    pass it to _build.launch, which loads (_build.load(width)) and calls
    that library's entry; a 13-bit config never builds or loads the 12-bit
    instances, nor a 12-bit one the 13-bit library. Meta tensors stand for
    the card's (no kernel can launch on them); the build and the library's
    entries are recorded, not run, and the stream is a stand-in."""
    import contextlib
    from types import SimpleNamespace

    from msm_tpu_torch.ops import _build, cuda_convert, cuda_curve, cuda_hist

    built, called = [], []

    class FakeLib:
        def __init__(self, path):
            self.path = path

        def __getattr__(self, name):
            def entry(*args):
                called.append((self.path, name))
                return 0

            setattr(self, name, entry)
            return entry

    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "build", lambda w=13: built.append(w) or f"lib{w}.so")
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    monkeypatch.setattr(_build, "require_cuda", lambda cfg, *t, dtype=None: check_cuda_config(cfg))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: SimpleNamespace(cuda_stream=0))
    cfg = MsmConfig(curve=BN254, word_size=width)
    meta = {"device": "meta", "dtype": torch.int32}
    for _ in range(2):
        cuda_curve.point_add(cfg, *(torch.empty((8, cfg.num_words), **meta) for _ in range(6)))
        cuda_hist.bucket_hist(cfg, torch.empty((2, 64), **meta), 16)
        cuda_convert.convert_pack(cfg, *(torch.empty((8, 16), device="meta", dtype=torch.int16) for _ in range(2)))
    assert built == [width] and list(_build._libs) == [width]
    assert {path for path, _ in called} == {f"lib{width}.so"} and len(called) == 6


def test_kernel_launch_requires_cuda_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        require_cuda(pick_config(1 << 16), torch.zeros((4, 20), dtype=torch.int32))



@pytest.mark.parametrize("name", ["bls12_381", "secp256k1", "pallas"])
@pytest.mark.parametrize("kernel", ["compress_pairs", "bpr_phase1", "convert_pack_scaled"])
def test_bn254_only_wrappers_refuse_other_curves_before_launch(kernel, name):
    """The wrappers whose kernels ran BN254 alone before they were built for
    every curve (compress_pairs' forward and backward pair kernels, BPR
    phase 1, the scaled convert) take another curve: on tensors not on the
    CPU (meta tensors here stand for the card's: no kernel can launch on
    them) they stop at the check for CUDA tensors, not at a curve refusal;
    on CPU tensors they run their twins."""
    from msm_tpu_torch.ops.cuda_bpr import bpr_phase1
    from msm_tpu_torch.ops.cuda_compress import compress_pairs
    from msm_tpu_torch.ops.cuda_convert import convert_pack_scaled, coord_u16
    from msm_tpu_torch.params import CURVES, coord_words

    cfg = MsmConfig(curve=CURVES[name], compress=True)
    check_cuda_config(cfg)
    check_cuda_config(dataclasses.replace(cfg, glv=True))
    meta = {"device": "meta", "dtype": torch.int32}
    L, D = cfg.num_words, coord_words(cfg)
    calls = {
        "compress_pairs": lambda: compress_pairs(cfg, torch.empty((8, 2 * D), **meta),
                                                 torch.empty((1, 4, 8), **meta), torch.empty((1, 4, 8), **meta)),
        "bpr_phase1": lambda: bpr_phase1(cfg, *(torch.empty((1, 4, 8, L), **meta) for _ in range(3))),
        "convert_pack_scaled": lambda: convert_pack_scaled(
            cfg, *(torch.empty((8, coord_u16(cfg)), device="meta", dtype=torch.int16) for _ in range(2))),
    }
    with pytest.raises(ValueError, match="expected tensors on one CUDA device, got meta"):
        calls[kernel]()
