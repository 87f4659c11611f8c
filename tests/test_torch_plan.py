"""msm_tpu_torch's serving plan (models/plan.py) on the CPU (every kernel
replaced by its plain twin) against msm_tpu.plan (JAX on the CPU) and the
oracle, at chunk 8 and n = 35 (padded to 64): scalar sets as ints and as
u16 words of several dtypes and row counts (every word but the top one
>= 0x8000 in one set: the top word of a scalar below r is < 0x3065), through
one run_batch; the affine call and the identity; the host buffer's
padding rows; the wire's pack and unpack and scalars_to_words against the
JAX package's; validation and the errors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import affine_points, port_cfg
import msm_tpu
import msm_tpu_torch
from msm_tpu.models import plan as jplan
from msm_tpu.oracle.pyecc import Curve as JCurve
from msm_tpu.params import BN254 as JBN254
from msm_tpu.params import MsmConfig as JMsmConfig
from msm_tpu_torch.models import common
from msm_tpu_torch.models.plan import scalars_to_words
from msm_tpu_torch.oracle import best_msm
from msm_tpu_torch.oracle.pyecc import Curve
from msm_tpu_torch.params import BN254

JCFG = JMsmConfig(curve=JBN254, chunk_size=8)
CFG = port_cfg(JCFG)
CV = Curve(BN254)
R = BN254.order
n, N = 35, 64


def _scalars(count, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % R for _ in range(count)]


def _ints(words):
    return [int.from_bytes(row.astype("<u2").tobytes(), "little") for row in words]


def _high_words(seed):
    """uint16 [n, 16]: words 0..14 in [0x8000, 0xFFFF], the top word below
    r's (so k < r)."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0x8000, 0x10000, size=(n, 16)).astype(np.uint16)
    w[:, 15] = rng.integers(0, R >> 240, size=n)
    return w


PTS = affine_points(CFG, n, seed=3)
KS1, KS2 = _scalars(n, 50), _scalars(n, 51)
GEN = (BN254.gx, BN254.gy)
PAD_KS = _scalars(N - n, 52)
HIGH = _high_words(53)
#: label -> (the set as run_batch takes it, the points and ints it means)
SETS = {
    "ints": (KS1, PTS, KS1),
    "all zero": ([0] * n, PTS, [0] * n),
    "edge 0, 1, r - 1, r + 5": ([0, 1, R - 1, R + 5] + [7] * (n - 4), PTS, [0, 1, R - 1, 5] + [7] * (n - 4)),
    "int32 words, N rows (pad_scalars_words)": (common.pad_scalars_words(KS2, CFG, N), PTS, KS2),
    "uint16 words, n rows": (common.ints_to_u16_array(KS2), PTS, KS2),
    # N rows are taken as they are: the padding rows' scalars multiply the
    # padding points (the generator)
    "uint16 words, N rows": (common.ints_to_u16_array(KS1 + PAD_KS), PTS + [GEN] * (N - n), KS1 + PAD_KS),
    "uint16 words >= 0x8000, n rows": (HIGH, PTS, _ints(HIGH)),
    "int16 words >= 0x8000, n rows": (HIGH.view(np.int16), PTS, _ints(HIGH)),
}


@pytest.fixture(scope="module")
def plan():
    return msm_tpu_torch.plan(PTS, config=CFG, device="cpu")


@pytest.fixture(scope="module")
def batch(plan):
    """Every set of SETS through one run_batch (B = 8)."""
    return dict(zip(SETS, plan.run_batch([s for s, _, _ in SETS.values()])))


@pytest.mark.parametrize("label", list(SETS))
def test_run_batch_matches_oracle(batch, label):
    _, pts, ks = SETS[label]
    assert CV.eq(batch[label], best_msm(pts, ks))


def test_plan_matches_jax_plan(batch):
    """The JAX plan over the same points, with ints and with its own words."""
    jp = msm_tpu.plan(PTS, config=JCFG)
    jcv = JCurve(JBN254)
    for label, ks in (("ints", KS1), ("int32 words, N rows (pad_scalars_words)", common.pad_scalars_words(KS2, CFG, N))):
        assert jcv.to_affine(jp.jpoint(ks)) == CV.to_affine(batch[label])


def test_affine_call_and_identity(plan, batch):
    assert plan(KS1) == CV.to_affine(batch["ints"])
    assert plan([0] * n) is None


def test_run_batch_empty(plan):
    assert plan.run_batch([]) == []


def test_padding_rows_zeroed_between_calls(plan):
    """An n-row set staged after an N-row one into the same slot leaves the
    padding rows zero again; an N-row set fills them."""
    full = np.full((N, 16), 0xABCD, np.uint16)
    plan._stage(0, full)
    assert (plan._staging[0].numpy() == np.int32(np.uint32(0xABCDABCD))).all()
    plan._stage(0, HIGH)
    buf = plan._staging[0].numpy()
    assert np.array_equal(buf[:n], HIGH.view(np.int32)) and not buf[n:].any()
    plan._stage(0, KS1)
    assert np.array_equal(buf, common.pack_scalar_words(common.pad_scalars_words(KS1, CFG, N)))


def test_pack_unpack_match_jax():
    """pack_scalar_words and unpack_scalar_words against the JAX plan's
    _pack_scalar_words_host and _unpack_scalar_words, on words spanning
    [0, 0xFFFF] (every word >= 0x8000 in half the rows)."""
    rng = np.random.default_rng(54)
    words = rng.integers(0, 0x10000, size=(2 * N, 16)).astype(np.int32)
    words[N:] |= 0x8000
    want = jplan._pack_scalar_words_host(words)
    for w in (words, words.astype(np.uint16), words.astype(np.uint16).view(np.int16)):
        assert np.array_equal(common.pack_scalar_words(w), want)
    got = common.unpack_scalar_words(torch.from_numpy(common.pack_scalar_words(words)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(jplan._unpack_scalar_words(jnp.asarray(want))))
    assert np.array_equal(got.numpy(), words)


@pytest.mark.parametrize("kind", ["ints", "ints out of range", "words n rows", "words N rows"])
def test_scalars_to_words_matches_jax(kind):
    ks = {"ints": KS1, "ints out of range": [R + 5, -3, R - 1] + KS1[3:],
          "words n rows": common.ints_to_u16_array(KS1), "words N rows": common.pad_scalars_words(KS2, CFG, N)}[kind]
    got = scalars_to_words(ks, CFG, n, N)
    assert got.dtype == np.int32 and got.shape == (N, 16)
    assert np.array_equal(got, jplan.scalars_to_words(ks, JCFG, n, N))


def test_validate_rejects_off_curve():
    bad = list(PTS[:16])
    bad[3] = (bad[3][0], (bad[3][1] + 1) % BN254.modulus)
    with pytest.raises(ValueError, match="not on the curve"):
        msm_tpu_torch.plan(bad, config=CFG, validate=True, device="cpu")


def test_wrong_scalar_count(plan):
    with pytest.raises(ValueError):
        plan.jpoint(KS1[:-1])
    with pytest.raises(ValueError):
        plan.jpoint(common.ints_to_u16_array(KS1[:-1]))
    with pytest.raises(ValueError):
        plan.jpoint(np.zeros((n, 8), np.uint16))
    with pytest.raises(ValueError):
        msm_tpu_torch.plan([], config=CFG, device="cpu")
