"""Build and load the CUDA kernels of ``msm_tpu_torch/csrc``.

Each ``csrc/*.cu`` file compiles with ``nvcc`` for ``sm_90a`` into an object
file (in parallel), and the objects link into one shared library with a
plain C interface, loaded with ``ctypes``. The build happens at first use,
into ``build/msm_tpu_torch/<hash of the sources>/`` under the repository
root, so an edited source never meets a stale library. ``nvcc`` is found on
``PATH``, else under ``$CUDA_HOME/bin``, else ``/usr/local/cuda/bin``.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``launch`` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from msm_tpu_torch.params import MsmConfig

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = CSRC.parent.parent / "build" / "msm_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

#: the H100 SXM the launch plans are sized for: SMs; shared memory a block
#: may use, an SM holds and the runtime reserves per block (bytes); threads
#: an SM holds
SMS = 132
SMEM_PER_BLOCK, SMEM_PER_SM, SMEM_RESERVED_PER_BLOCK = 232448, 233472, 1024
THREADS_PER_SM = 2048
#: threads an SM holds on the word core's kernels: 4 blocks of 128 at their
#: 128 registers per thread (__launch_bounds__(128, 4))
WORD_THREADS_PER_SM = 512

P, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
#: C entry points: argument types (every one returns the launch's error code)
SIGNATURES = {
    "msm_point_add": [P] * 9 + [I64, I32, P],
    "msm_convert": [P, P, P, I64, P],
    "msm_convert_glv": [P, P, P, I64, P],
    "msm_convert_scaled": [P] * 6 + [I64, I32, P],
    "msm_hist": [P, P, I64, I64, I32, I64, I32, P],
    "msm_scan": [P] * 7 + [I64, I32, I32, P],
    "msm_scan_rows_glv": [P] * 7 + [I64, I32, I32, P],
    "msm_row_offsets": [P] * 9 + [I64, I32, I32, I32, I32, P],
    "msm_point_total": [P] * 7 + [I64, I64, I32, I32, P],
    "msm_horner": [P] * 6 + [I64, I32, I32, P],
    "msm_mont_pow": [P] * 3 + [I32, I64, I32, P],
    "msm_pair_suffix": [P] * 4 + [I64, I32, I32, P],
    "msm_pair_suffix_glv": [P] * 4 + [I64, I32, I32, P],
    "msm_emit_scan": [P] * 9 + [I64, I32, I32, P],
    "msm_emit_scan_glv": [P] * 9 + [I64, I32, I32, P],
    "msm_pair_forward": [P] * 4 + [I64, I32, I32, P],
    "msm_pair_backward": [P] * 8 + [I64, I32, I32, P],
    "msm_pair_forward_glv": [P] * 4 + [I64, I32, I32, P],
    "msm_pair_backward_glv": [P] * 8 + [I64, I32, I32, P],
    "msm_bpr_phase1": [P] * 9 + [I64, I32, I32, P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def check_cuda_config(cfg: MsmConfig) -> None:
    """The CUDA kernels implement BN254 with 13-bit limbs, plain or pair
    compressed, with or without GLV (the convert, the scan and the four
    pair kernels have GLV modes); Karatsuba is not ported."""
    if cfg.curve.name != "bn254" or cfg.word_size != 13 or cfg.karatsuba:
        raise NotImplementedError(
            f"CUDA kernels support BN254 / word_size 13 without Karatsuba; "
            f"got curve={cfg.curve.name} word_size={cfg.word_size} "
            f"karatsuba={cfg.karatsuba}"
        )


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found on PATH, under $CUDA_HOME or /usr/local/cuda")


def sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / "libmsm_tpu_torch.so"


def build() -> Path:
    """Compile the kernels if this source hash has no library yet; returns
    the library path. The compiler's register/spill report goes to
    ``build.log`` beside the library."""
    so = library_path()
    if so.exists():
        return so
    out_dir = so.parent
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    cus = [p for p in sources() if p.suffix == ".cu"]

    def compile_one(src: Path) -> tuple[Path, str]:
        obj = out_dir / (src.stem + ".o")
        r = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            capture_output=True, text=True,
        )
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{r.stderr}")
        return obj, r.stdout + r.stderr

    with ThreadPoolExecutor(max_workers=len(cus)) as pool:
        results = list(pool.map(compile_one, cus))
    tmp = out_dir / f"lib.{os.getpid()}.so"
    r = subprocess.run(
        [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
         "-o", str(tmp), *[str(o) for o, _ in results]],
        capture_output=True, text=True,
    )
    if r.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{r.stderr}")
    (out_dir / "build.log").write_text("".join(log for _, log in results))
    os.replace(tmp, so)
    return so


def load() -> ctypes.CDLL:
    """Build if needed and load the library (once per process)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def require_cuda(cfg: MsmConfig, *tensors: torch.Tensor, dtype=torch.int32) -> None:
    """Checks before a launch: supported config, CUDA contiguous tensors of
    ``dtype`` on one device."""
    check_cuda_config(cfg)
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"expected tensors on one CUDA device, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("expected contiguous tensors")


def aligned(*tensors: torch.Tensor) -> list[torch.Tensor]:
    """The tensors contiguous and 16-byte aligned (copied where they are
    not), for kernels that read limb rows with 16-byte vector loads."""
    out = [t.contiguous() for t in tensors]
    return [t if t.data_ptr() % 16 == 0 else t.clone() for t in out]


def launch(name: str, *args) -> None:
    """Call C entry ``name`` on the current stream. Tensors pass as device
    pointers, ints as they are; the stream is appended."""
    lib = load()
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        err = getattr(lib, name)(*cargs, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
