"""msm_tpu_torch field and curve layers against msm_tpu's FieldCtx/CurveCtx
on the same numpy inputs (BN254 and BLS12-381). The field layer runs the
reference's algorithm step for step, so the comparisons are exact on the
limbs after canonical() on both sides. Where one test takes many of the
reference's outputs, they are computed in one jitted function: eagerly,
each of its products' scans is traced and compiled anew."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import affine_points, mont_limbs, port_cfg, rand_balanced
from msm_tpu.ops.curve import CurveCtx as JCurve
from msm_tpu.ops.curve import PointBatch as JPB
from msm_tpu.ops.field import FieldCtx as JField
from msm_tpu.oracle.pyecc import Curve
from msm_tpu.params import BLS12_381, BN254, CURVES, MsmConfig
from msm_tpu.utils import limbs as L
from msm_tpu_torch.ops.curve import CurveCtx, PointBatch
from msm_tpu_torch.ops.field import FieldCtx

CURVE_PARAMS = [BN254, BLS12_381]


def _pair(curve):
    jcfg = MsmConfig(curve=curve)
    cfg = port_cfg(jcfg)
    return cfg, JField(jcfg), FieldCtx(cfg)


def _same_canonicals(tf, j_canonicals, t_outs) -> bool:
    """The reference's outputs, canonicalized by the reference, against the
    port's canonicalized by the port, one for one."""
    assert len(j_canonicals) == len(t_outs)
    return all(np.array_equal(np.asarray(j), tf.canonical(t).numpy()) for j, t in zip(j_canonicals, t_outs))


@pytest.mark.parametrize("word_size", [13, 12])
@pytest.mark.parametrize("curve", CURVE_PARAMS, ids=lambda c: c.name)
def test_mont_mul_limbs_match_reference_on_both_paths(curve, word_size):
    """The Montgomery product's balanced limbs, not only their residues,
    equal the reference's: on CPU tensors (numpy arrays) and on the tensor
    path that CUDA tensors take (here run on CPU tensors), over a batch, a
    broadcast operand and a single element."""
    jcfg = MsmConfig(curve=curve, word_size=word_size)
    cfg, jf, tf = port_cfg(jcfg), JField(jcfg), FieldCtx(port_cfg(jcfg))
    rng = np.random.default_rng(4)
    L = tf.L
    for sa, sb in (((37,), (37,)), ((5, 8), (1, 8)), ((), ())):
        a, b = rand_balanced(rng, sa, cfg), rand_balanced(rng, sb, cfg)
        want = np.asarray(jf.mont_mul(jnp.asarray(a), jnp.asarray(b)))
        got = tf.mont_mul(torch.from_numpy(a), torch.from_numpy(b))
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
        ta, tb = (t.reshape(-1, L).T.contiguous() for t in torch.broadcast_tensors(torch.from_numpy(a),
                                                                                    torch.from_numpy(b)))
        tensor_path = tf._cios(ta, tb, torch.from_numpy(tf.p_limbs)[:, None], torch.from_numpy(tf.fold_c)[:, None],
                               lambda rows: torch.zeros((rows, ta.shape[1]), dtype=torch.int32))
        assert np.array_equal(tensor_path.T.reshape(want.shape).numpy(), want)


@pytest.mark.parametrize("curve", CURVE_PARAMS, ids=lambda c: c.name)
def test_field_ops_match_reference(curve):
    cfg, jf, tf = _pair(curve)
    rng = np.random.default_rng(3)
    a = rand_balanced(rng, (48,), cfg)
    b = rand_balanced(rng, (48,), cfg)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)

    @jax.jit
    def reference(ja, jb):
        outs = [jf.add(ja, jb), jf.sub(ja, jb)] + [getattr(jf, n)(ja) for n in ("neg", "double", "to_mont", "from_mont")]
        return jf.mont_mul(ja, jb), [jf.canonical(o) for o in outs], jf.canonical(ja), jf.eq(ja, ja + 0)

    j_mul, j_canon, j_a, j_eq = reference(jnp.asarray(a), jnp.asarray(b))
    # mont_mul follows the reference bit for bit, before canonical too
    assert np.array_equal(np.asarray(j_mul), tf.mont_mul(ta, tb).numpy())
    t_outs = [tf.add(ta, tb), tf.sub(ta, tb)] + [getattr(tf, n)(ta) for n in ("neg", "double", "to_mont", "from_mont")]
    assert _same_canonicals(tf, j_canon, t_outs)
    assert np.array_equal(np.asarray(j_a), tf.canonical(ta).numpy())
    assert np.array_equal(np.asarray(j_eq), tf.eq(ta, ta.clone()).numpy())


@pytest.mark.parametrize("curve", CURVE_PARAMS, ids=lambda c: c.name)
def test_canonical_edges(curve):
    """Values 0, 1, p-1, p, p+1, 2p-1 and their negations canonicalize to
    the exact residue, as in the reference."""
    cfg, jf, tf = _pair(curve)
    p = curve.modulus
    vals = [0, 1, p - 1, p, p + 1, 2 * p - 1]
    x = L.ints_to_limbs(vals, cfg.word_size, cfg.num_words).astype(np.int32)
    x = np.concatenate([x, -x])
    got = tf.canonical(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, np.asarray(jf.canonical(jnp.asarray(x))))
    want = [v % p for v in vals] + [(-v) % p for v in vals]
    assert [L.limbs_to_int(r, cfg.word_size) for r in got] == want


def _points(cfg, n, seed):
    """n random points plus the identity, P and -P, Montgomery projective."""
    aff = affine_points(cfg, n, seed)
    xs = [x for x, _ in aff] + [0, aff[0][0]]
    ys = [y for _, y in aff] + [1, cfg.curve.modulus - aff[0][1]]
    zs = [1] * n + [0, 1]
    return [mont_limbs(v, cfg) for v in (xs, ys, zs)]


@pytest.mark.parametrize("curve", CURVE_PARAMS, ids=lambda c: c.name)
def test_curve_ops_match_reference(curve):
    jcfg = MsmConfig(curve=curve)
    cfg = port_cfg(jcfg)
    jc, tc = JCurve(jcfg), CurveCtx(cfg)
    p = _points(cfg, 6, seed=11)
    q = [np.roll(a, 1, axis=0) for a in _points(cfg, 6, seed=11)]  # P + P, P + (-P) ...
    mask = np.arange(p[0].shape[0]) % 2 == 0

    @jax.jit
    def reference(p, q, mask):
        jp, jq = JPB(*p), JPB(*q)
        outs = [*jc.add(jp, jq), *jc.double(jp), *jc.neg(jp), jc.from_affine_mont(jp.x, jp.y).z,
                jc.neg_where(mask, jp).y]
        return [jc.f.canonical(o) for o in outs], jc.eq(jp, jq), jc.is_identity(jp)

    j_canon, j_eq, j_ident = reference(tuple(map(jnp.asarray, p)), tuple(map(jnp.asarray, q)), jnp.asarray(mask))
    tp, tq = PointBatch(*map(torch.from_numpy, p)), PointBatch(*map(torch.from_numpy, q))
    t_outs = [*tc.add(tp, tq), *tc.double(tp), *tc.neg(tp), tc.from_affine_mont(tp.x, tp.y).z,
              tc.neg_where(torch.from_numpy(mask), tp).y]
    assert _same_canonicals(tc.f, j_canon, t_outs)
    assert np.array_equal(np.asarray(j_eq), tc.eq(tp, tq).numpy())
    assert np.array_equal(np.asarray(j_ident), tc.is_identity(tp).numpy())


@pytest.mark.parametrize(
    "curve_name", ["bn254", "bls12_377", "bls12_381", "pallas", "secp256k1", "grumpkin", "vesta"]
)
def test_double_chain_bounded_with_R_offset_representation(curve_name):
    """Port of the reference regression (tests/test_curve.py): a y limb
    vector carrying a -R offset (top limb -2^w) is value-correct mod p but
    of magnitude ~R; without the top-limb renormalization fold the doubling
    chain amplifies it to int32 overflow. Twelve doublings must stay exact
    and limb-bounded."""
    spec = CURVES[curve_name]
    cfg = port_cfg(MsmConfig(curve=spec))
    cv = Curve(spec)
    p = spec.modulus
    ec = CurveCtx(cfg)
    g = cv.sample_points(1, seed=5)[0]
    gx, gy = cv.to_affine(g)
    lx, ly, lz = (m[0].astype(np.int64) for m in (mont_limbs([v], cfg) for v in (gx, gy, 1)))
    ly[-1] -= 1 << cfg.word_size
    ly += L.int_to_limbs((1 << cfg.word_size * cfg.num_words) % p, cfg.word_size,
                         cfg.num_words).astype(np.int64)
    d = PointBatch(*(torch.from_numpy(a.astype(np.int32)) for a in (lx, ly, lz)))
    gg = cv.from_affine(gx, gy)
    for _ in range(12):
        d = ec.double(d)
        gg = cv.double(gg)
    X, Y, Z = (L.limbs_to_int(a.numpy().astype(np.int64), cfg.word_size) * cfg.rinv % p for a in d)
    zi = pow(Z, -1, p)
    assert (X * zi % p, Y * zi % p) == cv.to_affine(gg)
    for a in d:
        assert int(a.abs().max()) < 1 << (cfg.word_size + 2), curve_name
