"""msm_tpu_torch.ops.bigint against msm_tpu.ops.bigint on the same numpy
inputs, bit for bit (integer arithmetic, no tolerance): add, sub, gte,
mul_raw, mul, carry_propagate, shr_bits, is_zero, eq and the overflow
budget, with the maximum-value and carry-cascade cases of the reference's
own tests. Then the budget at the entries: word sizes 14 to 16 raise
ValueError on the CPU before any work, as the JAX package's FieldCtx does
(before, the CPU path's int32 columns overflowed silently and a 16-bit
MSM returned a wrong point), and NotImplementedError on CUDA."""

import inspect
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msm_tpu_torch
from _torch_helpers import affine_points
from msm_tpu.ops import bigint as jbig
from msm_tpu.ops.field import FieldCtx as JField
from msm_tpu.params import BN254 as J_BN254
from msm_tpu.params import MsmConfig as JConfig
from msm_tpu.utils import limbs as L
from msm_tpu_torch.models import common
from msm_tpu_torch.models.naive import compute_msm_naive
from msm_tpu_torch.ops import bigint
from msm_tpu_torch.ops.curve import CurveCtx
from msm_tpu_torch.ops.field import FieldCtx
from msm_tpu_torch.oracle.pyecc import Curve
from msm_tpu_torch.params import BN254, MsmConfig

CFG = MsmConfig(curve=BN254)
W, NW = CFG.word_size, CFG.num_words


def _limbs(xs, nw=NW):
    return L.ints_to_limbs(xs, W, nw).astype(np.int32)


def _vals(n, seed, bits=254):
    rng = random.Random(seed)
    edge = [0, 1, CFG.mask, (1 << bits) - 1, BN254.modulus - 1, BN254.modulus, (1 << (W * NW)) - 1]
    return edge + [rng.randrange(1 << bits) for _ in range(n)]


A, B = _limbs(_vals(16, 1)), _limbs(_vals(16, 2))


def _both(name, *args, **kw):
    """(the JAX package's result, the port's) of bigint.<name> on the same
    numpy inputs, each as a tuple of numpy arrays."""
    j = getattr(jbig, name)(*(jnp.asarray(a) for a in args), **kw)
    t = getattr(bigint, name)(*(torch.from_numpy(a) for a in args), **kw)
    j, t = (r if isinstance(r, tuple) else (r,) for r in (j, t))
    return tuple(np.asarray(x) for x in j), tuple(x.numpy() for x in t)


@pytest.mark.parametrize("name", ["add", "sub", "gte", "mul"])
def test_binary_ops_match_reference(name):
    j, t = _both(name, A, B, word_size=W)
    assert len(j) == len(t)
    for a, b in zip(j, t):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    if name == "mul":  # and the product itself
        va, vb = L.limbs_to_ints(A, W), L.limbs_to_ints(B, W)
        assert L.limbs_to_ints(t[0], W) == [x * y for x, y in zip(va, vb)]


def test_mul_raw_and_eq_is_zero_match_reference():
    j, t = _both("mul_raw", A, B)
    assert np.array_equal(j[0], t[0])
    for name, args in (("eq", (A, B)), ("eq", (A, A)), ("is_zero", (A * 0,)), ("is_zero", (A,))):
        j, t = _both(name, *args)
        assert np.array_equal(j[0], t[0]), name


def test_mul_max_values_match_reference():
    """All limbs at the mask: the column budget's worst case."""
    maxv = _limbs([(1 << (W * NW)) - 1] * 2)
    j, t = _both("mul", maxv, maxv, word_size=W)
    assert np.array_equal(j[0], t[0])
    assert L.limbs_to_int(t[0][0], W) == ((1 << (W * NW)) - 1) ** 2


def test_carry_propagate_cascade_matches_reference():
    """Raw columns at NW * mask^2 cascade a carry through every limb."""
    x = np.full((2, NW), NW * CFG.mask**2, dtype=np.int32)
    j, t = _both("carry_propagate", x, word_size=W)
    assert all(np.array_equal(a, b) for a, b in zip(j, t))
    assert (t[0] <= CFG.mask).all()


@pytest.mark.parametrize("shift", [0, 6, 13, 253, 255, 300])
def test_shr_bits_matches_reference(shift):
    rng = random.Random(7)
    x = _limbs([rng.randrange(1 << 500) for _ in range(8)], 40)
    j, t = _both("shr_bits", x, nbits=shift, word_size=W, out_words=21)
    assert np.array_equal(j[0], t[0])
    assert L.limbs_to_ints(t[0], W) == [(v >> shift) % (1 << (W * 21)) for v in L.limbs_to_ints(x, W)]


@pytest.mark.parametrize("word_size", range(8, 17))
def test_overflow_budget_matches_reference(word_size):
    for nw in (19, 20, 21, 22, 28, 30, 31, 33, 49):
        try:
            jbig.check_overflow_budget(word_size, nw)
            want = None
        except ValueError as e:
            want = str(e)
        if want is None:
            bigint.check_overflow_budget(word_size, nw)
        else:
            with pytest.raises(ValueError) as got:
                bigint.check_overflow_budget(word_size, nw)
            assert str(got.value) == want


WIDE = [14, 15, 16]


def _at_width(word_size):
    """BN254 at this limb width (8-bit windows: small MSMs)."""
    return MsmConfig(curve=BN254, word_size=word_size, chunk_size=8)


@pytest.mark.parametrize("word_size", WIDE)
def test_field_ctx_refuses_wide_words_as_reference(word_size):
    with pytest.raises(ValueError) as want:
        JField(JConfig(curve=J_BN254, word_size=word_size))
    with pytest.raises(ValueError) as got:
        FieldCtx(_at_width(word_size))
    assert str(got.value) == str(want.value)


ENTRIES = {
    "run_gpu_msm": lambda cfg, pts, ks: msm_tpu_torch.run_gpu_msm(pts, ks, config=cfg, device="cpu"),
    "plan": lambda cfg, pts, ks: msm_tpu_torch.plan(pts, config=cfg, device="cpu"),
    "batched": lambda cfg, pts, ks: msm_tpu_torch.run_gpu_msm_batched([(pts, ks)], cfg, device="cpu"),
    "sharded": lambda cfg, pts, ks: msm_tpu_torch.run_gpu_msm_sharded(pts, ks, cfg, devices=["cpu", "cpu"]),
    "naive": lambda cfg, pts, ks: compute_msm_naive(pts, ks, cfg, device="cpu"),
}


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("word_size", WIDE)
def test_entries_refuse_wide_words_on_cpu(word_size, entry, monkeypatch):
    """Four sampled points at word_size 14 to 16 on the CPU: ValueError
    before any work (no point is padded or serialized). At 16 this MSM
    used to return a point that differs from the oracle's, with no
    error."""
    pts = affine_points(CFG, 4, seed=3)
    ks = msm_tpu_torch.sample_scalars(4, seed=4)

    def no_work(*args, **kw):
        raise AssertionError("work began before the config was refused")

    monkeypatch.setattr(common, "pad_points_words", no_work)
    monkeypatch.setattr(common, "pad_inputs", no_work)
    with pytest.raises(ValueError, match=f"word_size={word_size}, num_words=.* overflows int32"):
        ENTRIES[entry](_at_width(word_size), pts, ks)


@pytest.mark.parametrize("word_size", WIDE)
def test_entries_refuse_wide_words_on_cuda_first(word_size):
    """On CUDA the kernels' rule refuses first (NotImplementedError),
    before any launch or field context."""
    pts = affine_points(CFG, 4, seed=3)
    with pytest.raises(NotImplementedError, match=f"word_size[ =]{word_size}"):
        common.check_config(_at_width(word_size), "cuda")
    with pytest.raises(NotImplementedError, match=f"word_size[ =]{word_size}"):
        msm_tpu_torch.run_gpu_msm(pts, [1, 2, 3, 4], config=_at_width(word_size), device="cuda")


def test_narrow_words_still_run_on_cpu():
    """Word sizes 12 and 13 pass the budget: the same four points' MSM
    equals the oracle's."""
    pts = affine_points(CFG, 4, seed=3)
    ks = msm_tpu_torch.sample_scalars(4, seed=4)
    want = Curve(BN254).to_affine(msm_tpu_torch.cpu_msm(pts, ks))
    for w in (13, 12):
        assert msm_tpu_torch.run_gpu_msm(pts, ks, config=_at_width(w), device="cpu") == want


def test_device_defaults_are_cuda():
    """Entry helpers run on the card unless the caller asks for the CPU."""
    for fn in (CurveCtx.identity, common.validate_inputs, common.subgroup_mask_device):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__
