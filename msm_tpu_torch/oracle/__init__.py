"""CPU oracles of the port, for bit-exact verification — its own copy of
``msm_tpu.oracle``:

- ``pyecc``  pure-Python ints, always available, exact (slow)
- ``native`` the C++ Pippenger oracle, built at first use with g++
"""

from __future__ import annotations

from msm_tpu_torch.oracle.pyecc import IDENTITY, Curve, JPoint
from msm_tpu_torch.params import BN254


def _normalize_points(points, cv: Curve) -> list[JPoint]:
    return [p if isinstance(p, JPoint) else cv.from_affine(*p) for p in points]


def best_msm(points, scalars, curve=BN254) -> JPoint:
    """The fastest exact CPU MSM here: the C++ oracle for BN254 when it
    builds, else the pure-Python Pippenger."""
    from msm_tpu_torch.oracle.native import native_available, native_msm

    cv = Curve(curve)
    pts = _normalize_points(points, cv)
    if native_available(curve):
        return native_msm(pts, scalars, curve=curve)
    return cv.msm(pts, list(scalars))


__all__ = ["Curve", "JPoint", "IDENTITY", "best_msm"]
