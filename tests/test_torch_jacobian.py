"""msm_tpu_torch's JacobianCtx (dbl-2009-l, add-2007-bl with the edge
cases as selects) against msm_tpu's on the same numpy inputs, bit for bit
on every limb: add, double, neg and eq on random BN254 points with random
Z, and on the four branches P + P (two representations of one point),
P + (-P), O + P and P + O (and O + O). Then the results as points against
the integers (the oracle's addition) and against the port's complete
CurveCtx on the same curve points (one addition: no reassociation). Each
JAX result is computed once per module."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import affine_points, canon, mont_limbs, port_cfg
from msm_tpu.ops.curve import JacobianCtx as JJacobian
from msm_tpu.ops.curve import PointBatch as JPB
from msm_tpu.params import BN254, MsmConfig
from msm_tpu_torch.ops.curve import PointBatch, get_curve_ctx, get_jacobian_ctx
from msm_tpu_torch.oracle.pyecc import IDENTITY, Curve, JPoint

JCFG = MsmConfig(curve=BN254)
CFG = port_cfg(JCFG)
P = BN254.modulus
CV = Curve(CFG.curve)
RANDOM = 6
#: the lanes after the random pairs: (P, Q) as affine points or None (O)
BRANCHES = ("P + P", "P + (-P)", "O + P", "P + O", "O + O")


@functools.lru_cache(maxsize=None)
def _inputs():
    """(p, q) as affine points (None: the identity), and as Jacobian
    Montgomery limbs [n, L] x 3 with random Z."""
    pts = affine_points(CFG, 2 * RANDOM + 4, seed=31)
    p = pts[:RANDOM]
    q = pts[RANDOM : 2 * RANDOM]
    a, b = pts[2 * RANDOM], pts[2 * RANDOM + 1]
    p += [a, b, None, b, None]
    q += [a, (b[0], P - b[1]), a, None, None]
    rng = np.random.default_rng(32)

    def jacobian(pts):
        xs, ys, zs = [], [], []
        for pt in pts:
            z = int(rng.integers(2, 1 << 62))
            x, y, z = (0, 1, 0) if pt is None else (pt[0] * z * z % P, pt[1] * z**3 % P, z)
            xs.append(x)
            ys.append(y)
            zs.append(z)
        return tuple(mont_limbs(v, CFG) for v in (xs, ys, zs))

    return p, q, jacobian(p), jacobian(q)


@functools.lru_cache(maxsize=None)
def _jax():
    """The JAX package's add(p, q), double(p), neg(p), eq(p, q) and
    eq(add(p, q), add(q, p)), as numpy."""
    _, _, pj, qj = _inputs()
    jc = JJacobian(JCFG)

    @jax.jit  # one compile: eagerly, each product's scan is traced anew
    def run(jp, jq):
        s = jc.add(jp, jq)
        return {"add": s, "double": jc.double(jp), "neg": jc.neg(jp), "eq": jc.eq(jp, jq),
                "eq_sum": jc.eq(s, jc.add(jq, jp))}

    out = run(JPB(*map(jnp.asarray, pj)), JPB(*map(jnp.asarray, qj)))
    return {k: tuple(map(np.asarray, v)) if isinstance(v, tuple) else np.asarray(v) for k, v in out.items()}


@functools.lru_cache(maxsize=None)
def _port():
    _, _, pj, qj = _inputs()
    jc = get_jacobian_ctx(CFG)
    tp, tq = PointBatch(*map(torch.from_numpy, pj)), PointBatch(*map(torch.from_numpy, qj))
    s = jc.add(tp, tq)
    out = {"add": s, "double": jc.double(tp), "neg": jc.neg(tp), "eq": jc.eq(tp, tq),
           "eq_sum": jc.eq(s, jc.add(tq, tp))}
    return {k: tuple(t.numpy() for t in v) if isinstance(v, tuple) else v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("op", ["add", "double", "neg", "eq", "eq_sum"])
def test_matches_reference_limb_for_limb(op):
    got, want = _port()[op], _jax()[op]
    if isinstance(want, tuple):
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    else:
        assert np.array_equal(got, want)


def _affine(coords):
    """Jacobian Montgomery limbs -> affine ints (None: the identity)."""
    x, y, z = (canon(c, CFG) * CFG.rinv % P for c in coords)
    out = []
    for xi, yi, zi in zip(x, y, z):
        if zi == 0:
            out.append(None)
        else:
            zinv = pow(int(zi), -1, P)
            out.append((int(xi) * zinv**2 % P, int(yi) * zinv**3 % P))
    return out


def _oracle(pt):
    return IDENTITY if pt is None else JPoint(pt[0], pt[1], 1)


def _as_affine(jp: JPoint):
    return None if jp.is_identity() else CV.to_affine(jp)


def test_add_and_double_are_the_group_law():
    p, q, _, _ = _inputs()
    out = _port()
    assert _affine(out["add"]) == [_as_affine(CV.add(_oracle(a), _oracle(b))) for a, b in zip(p, q)]
    assert _affine(out["double"]) == [_as_affine(CV.double(_oracle(a))) for a in p]
    assert _affine(out["neg"]) == [None if a is None else (a[0], (P - a[1]) % P) for a in p]
    assert out["eq"].tolist() == [a == b for a, b in zip(p, q)]
    assert out["eq_sum"].all()


@pytest.mark.parametrize("lane", range(len(BRANCHES)))
def test_branches(lane):
    """Each select: the doubling, the identity, and the identity operands."""
    p, q, _, _ = _inputs()
    i = RANDOM + lane
    got = _affine(tuple(c[i : i + 1] for c in _port()["add"]))[0]
    want = {"P + P": _as_affine(CV.double(_oracle(p[i]))), "P + (-P)": None, "O + P": q[i], "P + O": p[i],
            "O + O": None}[BRANCHES[lane]]
    assert got == want


def test_matches_the_complete_formulas_on_curve_points():
    """The port's complete projective addition (kernel 1's plain twin) on
    the same affine points gives the same sums."""
    p, q, _, _ = _inputs()
    ec = get_curve_ctx(CFG)

    def projective(pts):
        xs = [0 if a is None else a[0] for a in pts]
        ys = [1 if a is None else a[1] for a in pts]
        zs = [0 if a is None else 1 for a in pts]
        return PointBatch(*(torch.from_numpy(mont_limbs(v, CFG)) for v in (xs, ys, zs)))

    s = ec.add(projective(p), projective(q))
    x, y, z = (canon(c.numpy(), CFG) * CFG.rinv % P for c in s)
    complete = [None if zi == 0 else (int(xi) * pow(int(zi), -1, P) % P, int(yi) * pow(int(zi), -1, P) % P)
                for xi, yi, zi in zip(x, y, z)]
    assert complete == _affine(_port()["add"])
