"""msm_tpu_torch.ops.twisted_ec against msm_tpu.ops.twisted_ec on Baby
Jubjub (EIP-2494), bit for bit on every limb: from_affine, identity, add,
double, neg and eq on the base point B, its small multiples and the
identity; then the results against the affine integer formulas of
twisted-Edwards addition and doubling, as the reference's test models
them. Each JAX result is computed once per module (one jit of the lot:
eagerly the reference takes ~20 s)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import canon
from msm_tpu.ops import twisted_ec as jte
from msm_tpu_torch.ops import twisted_ec as te

#: the EIP-2494 base point (8 times a generator of the prime-order subgroup)
BX = 5299619240641551281634865583518297030282874472190772894086521144482721001553
BY = 16950150798460657717958625567821834550301663161624707787222815936182638968203
SPEC = te.BABY_JUBJUB
Q = SPEC.modulus


def _add_affine(p1, p2):
    """Affine twisted-Edwards addition in integers (complete; doubling
    included)."""
    (x1, y1), (x2, y2) = p1, p2
    t = SPEC.d * x1 * x2 * y1 * y2 % Q
    x3 = (x1 * y2 + y1 * x2) * pow((1 + t) % Q, -1, Q) % Q
    y3 = (y1 * y2 - SPEC.a * x1 * x2) * pow((1 - t) % Q, -1, Q) % Q
    return x3, y3


def _on_curve(x, y):
    return (SPEC.a * x * x + y * y) % Q == (1 + SPEC.d * x * x * y * y) % Q


#: the lanes' affine points: O, B, 2B, 3B, 4B, -B; p pairs them with q
MULTIPLES = [(0, 1), (BX, BY)]
for _ in range(3):
    MULTIPLES.append(_add_affine(MULTIPLES[-1], (BX, BY)))
MULTIPLES.append(((Q - BX) % Q, BY))
P_LANES = [1, 1, 2, 0, 3, 1, 4]
Q_LANES = [1, 2, 1, 1, 0, 5, 4]


def _batch(mod, lanes, **kw):
    """The lanes' points as one ExtPoint of the module's context: each
    from_affine of one lane, stacked."""
    ctx = mod.get_twisted_ctx(mod.BABY_JUBJUB)
    pts = [ctx.from_affine(*MULTIPLES[i], batch_shape=(1,), **kw) for i in lanes]
    cat = jnp.concatenate if mod is jte else torch.cat
    return mod.ExtPoint(*(cat([p[k] for p in pts]) for k in range(4)))


@functools.lru_cache(maxsize=None)
def _jax():
    ctx = jte.get_twisted_ctx(jte.BABY_JUBJUB)
    p, q = _batch(jte, P_LANES), _batch(jte, Q_LANES)

    @jax.jit
    def run(p, q):
        return {"add": ctx.add(p, q), "double": ctx.double(p), "neg": ctx.neg(p), "eq": ctx.eq(p, q),
                "eq_commutes": ctx.eq(ctx.add(p, q), ctx.add(q, p))}

    out = {"from_affine": p, "identity": ctx.identity((3,)), **run(p, q)}
    return {k: tuple(map(np.asarray, v)) if isinstance(v, tuple) else np.asarray(v) for k, v in out.items()}


@functools.lru_cache(maxsize=None)
def _port():
    ctx = te.get_twisted_ctx(te.BABY_JUBJUB)
    p, q = _batch(te, P_LANES, device="cpu"), _batch(te, Q_LANES, device="cpu")
    out = {"from_affine": p, "identity": ctx.identity((3,), device="cpu"), "add": ctx.add(p, q),
           "double": ctx.double(p), "neg": ctx.neg(p), "eq": ctx.eq(p, q),
           "eq_commutes": ctx.eq(ctx.add(p, q), ctx.add(q, p))}
    return {k: tuple(t.numpy() for t in v) if isinstance(v, tuple) else v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("op", ["from_affine", "identity", "add", "double", "neg", "eq", "eq_commutes"])
def test_matches_reference_limb_for_limb(op):
    got, want = _port()[op], _jax()[op]
    if isinstance(want, tuple):
        assert len(got) == 4 and all(np.array_equal(g, w) for g, w in zip(got, want))
    else:
        assert np.array_equal(got, want)


def _affine(pt):
    """ExtPoint limbs (numpy) -> affine ints per lane."""
    ctx = te.get_twisted_ctx(SPEC)
    x, y, _, z = (canon(c, ctx.cfg) * ctx.cfg.rinv % Q for c in pt)
    return [(int(xi) * pow(int(zi), -1, Q) % Q, int(yi) * pow(int(zi), -1, Q) % Q) for xi, yi, zi in zip(x, y, z)]


def test_base_point_and_multiples_on_curve():
    assert all(_on_curve(*pt) for pt in MULTIPLES)


def test_add_double_neg_match_the_affine_formulas():
    out = _port()
    assert _affine(out["add"]) == [_add_affine(MULTIPLES[i], MULTIPLES[j]) for i, j in zip(P_LANES, Q_LANES)]
    assert _affine(out["double"]) == [_add_affine(MULTIPLES[i], MULTIPLES[i]) for i in P_LANES]
    assert _affine(out["neg"]) == [((Q - MULTIPLES[i][0]) % Q, MULTIPLES[i][1]) for i in P_LANES]
    assert out["eq"].tolist() == [i == j for i, j in zip(P_LANES, Q_LANES)]
    assert out["eq_commutes"].all()


def test_double_matches_the_reference_model():
    """dbl-2008-hwcd of B against x3 = 2xy / (a x^2 + y^2),
    y3 = (y^2 - a x^2) / (2 - a x^2 - y^2) (the reference test's model)."""
    axx, yy = SPEC.a * BX * BX % Q, BY * BY % Q
    want = (2 * BX * BY * pow((axx + yy) % Q, -1, Q) % Q, (yy - axx) * pow((2 - axx - yy) % Q, -1, Q) % Q)
    got = _affine(_port()["double"])[P_LANES.index(1)]
    assert got == want and _on_curve(*got)


def test_identity_and_group_laws():
    """P + O == P, P + (-P) == O, and the identity's limbs."""
    ctx = te.get_twisted_ctx(SPEC)
    b = ctx.from_affine(BX, BY, (2,), device="cpu")
    o = ctx.identity((2,), device="cpu")
    assert ctx.eq(ctx.add(b, o), b).all()
    assert ctx.eq(ctx.add(b, ctx.neg(b)), o).all()
    assert _affine(tuple(t.numpy() for t in o)) == [(0, 1)] * 2
