"""ctypes loader for the C++ fast oracle (``cpp/msm_oracle.cpp``, a copy of
the JAX package's source): 64-bit limbs, __int128 Montgomery products, a
serial Pippenger per window with OpenMP across windows. BN254 only.

The library is compiled at first use with the ``g++`` found on ``PATH``
(not ``$CXX``, which may name a compiler without OpenMP) into
``build/msm_tpu_torch/oracle/`` under the repository root, named by a hash
of the source and flags so that an edited source never meets a stale
library. When the build fails, ``native_available`` is False and
``best_msm`` uses the pure-Python oracle.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from msm_tpu_torch.oracle.pyecc import Curve, JPoint
from msm_tpu_torch.params import BN254, CurveSpec

SOURCE = Path(__file__).resolve().parent / "cpp" / "msm_oracle.cpp"
BUILD_DIR = SOURCE.parents[3] / "build" / "msm_tpu_torch" / "oracle"
FLAGS = ["-O3", "-fPIC", "-std=c++17", "-fopenmp", "-shared"]

_LIB = None
_LIB_TRIED = False


def lib_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libmsm_oracle.{h}.so"


def build() -> Path | None:
    """Compile the library unless this source's build exists; None when
    there is no g++ or the build fails."""
    path = lib_path()
    if path.exists():
        return path
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([gxx, *FLAGS, "-o", str(tmp), str(SOURCE)],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        return None
    os.replace(tmp, path)
    return path


def _load():
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    path = build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.msm_bn254.restype = ctypes.c_int
    lib.msm_bn254.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),  # points: n * 64 bytes (x||y LE)
        ctypes.POINTER(ctypes.c_uint8),  # scalars: n * 32 bytes LE
        ctypes.c_size_t,  # n
        ctypes.POINTER(ctypes.c_uint8),  # out: 96 bytes (x||y||z LE) Jacobian
    ]
    _LIB = lib
    return _LIB


def native_available(curve: CurveSpec = BN254) -> bool:
    return curve.name == "bn254" and _load() is not None


def native_msm(points: list[JPoint], scalars: list[int], curve: CurveSpec = BN254) -> JPoint:
    """Run the C++ Pippenger oracle. Points are JPoints (any Z); they are
    normalized to affine before the call."""
    lib = _load()
    if lib is None or curve.name != "bn254":
        raise RuntimeError("native oracle unavailable")
    cv = Curve(curve)
    n = len(points)
    pbuf = bytearray(64 * n)
    sbuf = bytearray(32 * n)
    for i, (pt, k) in enumerate(zip(points, scalars)):
        if pt.is_identity():
            x, y = 0, 0  # the C++ side reads x = y = 0 as infinity
        elif pt.z == 1:
            x, y = pt.x, pt.y
        else:
            x, y = cv.to_affine(pt)
        pbuf[64 * i : 64 * i + 32] = x.to_bytes(32, "little")
        pbuf[64 * i + 32 : 64 * i + 64] = y.to_bytes(32, "little")
        sbuf[32 * i : 32 * i + 32] = (k % curve.order).to_bytes(32, "little")
    obuf = (ctypes.c_uint8 * 96)()
    rc = lib.msm_bn254(
        (ctypes.c_uint8 * len(pbuf)).from_buffer(pbuf),
        (ctypes.c_uint8 * len(sbuf)).from_buffer(sbuf),
        n,
        obuf,
    )
    if rc != 0:
        raise RuntimeError(f"native msm failed rc={rc}")
    raw = bytes(obuf)
    x = int.from_bytes(raw[0:32], "little")
    y = int.from_bytes(raw[32:64], "little")
    z = int.from_bytes(raw[64:96], "little")
    return JPoint(x, y, z)
