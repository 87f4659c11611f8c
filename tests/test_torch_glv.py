"""The port's GLV module (msm_tpu_torch/ops/glv.py) against the JAX
package's (msm_tpu/ops/glv.py): the derived parameters on the seven a = 0
curves,
the window count under GLV, the host split, the tensor split (on edge,
knife-edge and random scalars, and with degraded Babai multipliers that
force the rounding correction), the decomposition's keys and signs, and
the payload decode that moves the phi bit into the flags. Exact
throughout."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _glv_split import check_decomposition, check_tensor_split, scalars, signed, words
from _torch_helpers import port_cfg
from msm_tpu import params as jparams
from msm_tpu.ops import glv as jglv
from msm_tpu.ops.scan import _decode_payload_step_major as j_decode
from msm_tpu_torch import params
from msm_tpu_torch.ops import glv
from msm_tpu_torch.ops.scan import _decode_payload_step_major

CURVES = ["bn254", "bls12_381", "bls12_377", "pallas", "secp256k1", "grumpkin", "vesta"]
#: the curves of the split and decomposition checks in this file (their
#: JAX programs compile for tens of seconds each on a cold cache)
SPLIT_CURVES = ["bn254", "bls12_381", "bls12_377"]


@pytest.mark.parametrize("name", CURVES)
def test_glv_params_match_jax(name):
    got, want = glv.glv_params(params.CURVES[name]), jglv.glv_params(jparams.CURVES[name])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.half_bits == want.half_bits


@pytest.mark.parametrize("name", CURVES)
def test_num_subtasks_under_glv_matches_jax(name):
    for chunk in (16, 13, 8, 1):
        j = jparams.MsmConfig(curve=jparams.CURVES[name], chunk_size=chunk, glv=True)
        assert port_cfg(j).num_subtasks == j.num_subtasks
    assert params.MsmConfig(curve=params.BN254, glv=True).num_subtasks == 8


@pytest.mark.parametrize("name", CURVES)
def test_splits_match_jax_host_split(name):
    """The host split and the tensor split against the JAX host split."""
    curve, jcurve = params.CURVES[name], jparams.CURVES[name]
    g, jg, r = glv.glv_params(curve), jglv.glv_params(jcurve), curve.order
    ks = scalars(g, r, extra=200, seed=3)
    want = [jglv.split_scalar(k, jg, r) for k in ks]
    assert [glv.split_scalar(k, g, r) for k in ks] == want
    a1, n1, a2, n2 = glv.split_scalars_device(torch.from_numpy(words(ks)), port_cfg(
        jparams.MsmConfig(curve=jcurve, glv=True)))
    assert a1.shape[1] == -(-(g.half_bits + 1) // 16) and a1.dtype == torch.int32
    assert list(zip(signed(a1, n1), signed(a2, n2))) == want
    assert any(k1 < 0 for k1, _ in want) and any(k2 < 0 for _, k2 in want)


@pytest.mark.parametrize("name", CURVES)
def test_rounding_correction_matches_jax(name):
    """Degraded multipliers g_j - 2^62 leave some candidates one below the
    rounded quotient; the corrected tensor split still equals the JAX
    split (its host split with the same degraded multipliers, which the
    JAX tests hold equal to its device split)."""
    curve, jcurve = params.CURVES[name], jparams.CURVES[name]
    g, jg, r = glv.glv_params(curve), jglv.glv_params(jcurve), curve.order
    E = 1 << 62
    bad = dataclasses.replace(g, g1=g.g1 - E, g2=g.g2 - E)
    jbad = dataclasses.replace(jg, g1=jg.g1 - E, g2=jg.g2 - E)
    rng = np.random.default_rng(11)
    ks = [int.from_bytes(rng.bytes(32), "little") % r for _ in range(160)]
    half = 1 << (glv.M_BITS - 1)
    fires = sum(2 * (k * b - ((k * gj + half) >> glv.M_BITS) * r) > r
                for k in ks for gj, b in ((bad.g1, g.v2[1]), (bad.g2, -g.v1[1])))
    assert fires > 0
    cfg = port_cfg(jparams.MsmConfig(curve=jcurve, glv=True))
    a1, n1, a2, n2 = glv._split_scalars_device(torch.from_numpy(words(ks)), cfg, bad)
    want = [jglv.split_scalar(k, jbad, r) for k in ks]
    assert list(zip(signed(a1, n1), signed(a2, n2))) == want


@pytest.mark.parametrize("name", SPLIT_CURVES)
def test_tensor_split_matches_jax_device_split(name):
    """The tensor split word for word and sign for sign against the JAX
    device split (tests/_glv_split.py; the other curves in
    test_torch_glv_pasta.py and _256.py)."""
    check_tensor_split(name)


@pytest.mark.parametrize("name", SPLIT_CURVES)
def test_glv_decomposition_matches_jax(name):
    """Keys and signs [S, 2n] at c = 16 on edge scalars (0, 1, r - 1,
    lambda, r - lambda, scalars with a negative half) and random ones."""
    check_decomposition(name)


def test_payload_decode_with_table_rows_matches_jax():
    """Payload over a 2n stream (index bits, sign above them) -> the
    physical row and flags with the phi bit in bit 1, step-major."""
    n, R = 64, 8
    rng = np.random.default_rng(5)
    sbit = (2 * n - 1).bit_length()
    pv = (rng.permutation(2 * n) | (rng.integers(0, 2, size=2 * n) << sbit)).astype(np.int32)
    perm, flags = _decode_payload_step_major(torch.from_numpy(pv)[None], sbit, R, table_rows=n)
    jperm, jflags = j_decode(jnp.asarray(pv), sbit, R, table_rows=n)
    C = 2 * n // R
    assert np.array_equal(perm[0].numpy().reshape(-1), np.asarray(jperm))
    assert np.array_equal(flags[0].numpy().reshape(-1), np.asarray(jflags))
    assert perm.shape == (1, C, R) and int(perm.max()) < n and set(np.unique(flags.numpy())) <= {0, 1, 2, 3}
