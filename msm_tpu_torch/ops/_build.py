"""Build and load the CUDA kernels of ``msm_tpu_torch/csrc``.

Each ``csrc/*.cu`` file (one per kernel, and one per curve besides BN254
holding that curve's instances of the plain path's kernels) compiles with
``nvcc`` for ``sm_90a`` into an object file (in parallel, every failure
reported), and the objects link into one shared library with a
plain C interface, loaded with ``ctypes``. The build happens at first use,
into ``build/msm_tpu_torch/<hash of the sources>/`` under the repository
root, so an edited source never meets a stale library. ``nvcc`` is found on
``PATH``, else under ``$CUDA_HOME/bin``, else ``/usr/local/cuda/bin``.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``launch`` raises when that is not 0. Every kernel
is generic over the field, and every entry but the histogram's (which has
no field) takes the curve's index in ``params.CURVES`` (``curve_id``)
before the stream and dispatches on it. Each other curve's instances
compile in four translation units of their own (``csrc/curve_<name>.cu``:
the point add, convert, scan and Horner ladder and the GLV convert and
scan; ``csrc/curve_<name>_prefix.cu``: the row offsets;
``csrc/curve_<name>_total.cu``: the point total; ``csrc/curve_<name>_pairs.cu``:
the pair kernels, BPR phase 1 and the scaled convert), so that no one
unit's compile outlasts the rest of the parallel build; each translation
unit's compile seconds go to ``compile_seconds.json`` beside the library,
with the build's wall seconds and ``os.cpu_count()``.

The limb width (``MsmConfig.word_size``, ``WIDTHS``) picks one of two
libraries of the same sources and C entries. The default one serves 13-bit
limbs, whose constants ``csrc/fields.cuh`` holds at compile time. The
narrow one serves widths 8 to 12: every ``.cu`` compiled again with
``-DMSM_LIMB_BITS=0`` (``NARROW_FLAGS``) into ``<hash>/narrow/``, where
the kernels read the width's constants at run time from a width block
(``csrc/widths.cuh``). Every C entry but the histogram's takes the width
after the curve index (``launch`` appends it), and the default library
refuses any width but 13. A library is built and loaded the first time a
config of one of its widths launches a kernel, so a 13-bit run never
builds the narrow one.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from msm_tpu_torch.params import CURVES, MsmConfig, coord_words

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = CSRC.parent.parent / "build" / "msm_tpu_torch"

#: the H100 SXM the launch plans are sized for: SMs; shared memory a block
#: may use, an SM holds and the runtime reserves per block (bytes); threads
#: an SM holds
SMS = 132
SMEM_PER_BLOCK, SMEM_PER_SM, SMEM_RESERVED_PER_BLOCK = 232448, 233472, 1024
THREADS_PER_SM = 2048
#: 128-thread blocks an SM holds on the word core's kernels, by words an
#: element (``params.coord_words``): the minimum of their __launch_bounds__,
#: 4 at 8 words (128 registers a thread), 2 at 12 (BLS12; 255). The one
#: table: every compile of csrc/fields.cuh gets it as MSM_BLOCKS_NW<words>
#: (``FIELD_FLAGS``), and the launch plans read it (``word_threads_per_sm``)
WORD_BLOCK, WORD_BLOCKS_PER_SM = 128, {8: 4, 12: 2}
FIELD_FLAGS = [f"-DMSM_BLOCKS_NW{words}={blocks}" for words, blocks in WORD_BLOCKS_PER_SM.items()]
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", *FIELD_FLAGS,
]

P, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
#: C entry points: argument types (every one returns the launch's error
#: code); every entry but the histogram's gains the limb width (I32) after
#: its curve index, below
SIGNATURES = {
    "msm_point_add": [P] * 9 + [I64, I32, I32, P],
    "msm_convert": [P, P, P, I64, I32, P],
    "msm_convert_glv": [P, P, P, I64, I32, P],
    "msm_convert_scaled": [P] * 6 + [I64, I32, I32, P],
    "msm_hist": [P, P, I64, I64, I32, I64, I32, P],
    "msm_scan": [P] * 7 + [I64, I32, I32, I32, P],
    "msm_scan_rows_glv": [P] * 7 + [I64, I32, I32, I32, P],
    "msm_row_offsets": [P] * 9 + [I64, I32, I32, I32, I32, I32, P],
    "msm_point_total": [P] * 7 + [I64, I64, I32, I32, I32, P],
    "msm_horner": [P] * 6 + [I64, I32, I32, I32, P],
    "msm_mont_pow": [P] * 3 + [I32, I64, I32, I32, P],
    "msm_pair_suffix": [P] * 4 + [I64, I32, I32, I32, P],
    "msm_pair_suffix_glv": [P] * 4 + [I64, I32, I32, I32, P],
    "msm_emit_scan": [P] * 9 + [I64, I32, I32, I32, P],
    "msm_emit_scan_glv": [P] * 9 + [I64, I32, I32, I32, P],
    "msm_pair_forward": [P] * 4 + [I64, I32, I32, I32, P],
    "msm_pair_backward": [P] * 8 + [I64, I32, I32, I32, P],
    "msm_pair_forward_glv": [P] * 4 + [I64, I32, I32, I32, P],
    "msm_pair_backward_glv": [P] * 8 + [I64, I32, I32, I32, P],
    "msm_bpr_phase1": [P] * 9 + [I64, I32, I32, I32, P],
}
#: the C entry without a field (and so without a width)
FIELDLESS = ("msm_hist",)
SIGNATURES = {name: args if name in FIELDLESS else args[:-1] + [I32, P] for name, args in SIGNATURES.items()}

#: the limb widths the kernels run: 13, the first, the default library's
#: (compiled without -DMSM_LIMB_BITS); the others (NARROW_WIDTHS) the
#: narrow library's, compiled with NARROW_FLAGS
WIDTHS = (13, 12, 11, 10, 9, 8)
NARROW_WIDTHS = WIDTHS[1:]
NARROW_FLAGS = ["-DMSM_LIMB_BITS=0"]
#: the two libraries
LIBRARIES = ("default", "narrow")
_locks = {lib: threading.Lock() for lib in LIBRARIES}
#: the loaded library by name
_libs: dict[str, ctypes.CDLL] = {}
#: a check's hook: when set, width 13 launches on the narrow library
#: (narrow_at_13)
_narrow_13 = False


#: the curve index the generic kernels' C entries take (fields.cuh F::ID)
CURVE_IDS = {name: i for i, name in enumerate(CURVES)}


def curve_id(cfg: MsmConfig) -> int:
    return CURVE_IDS[cfg.curve.name]


def word_threads_per_sm(cfg: MsmConfig) -> int:
    """Threads an SM holds on the word core's kernels for this curve
    (``WORD_BLOCKS_PER_SM``)."""
    return WORD_BLOCK * WORD_BLOCKS_PER_SM[coord_words(cfg)]


def karatsuba_ok(cfg: MsmConfig) -> bool:
    """Whether the JAX package builds its Karatsuba Montgomery product for
    this config (``msm_tpu/ops/pallas_curve.py::karatsuba_ok``, copied): an
    even limb count and both int32 column budgets clear."""
    w, L = cfg.word_size, cfg.num_words
    if L % 2:
        return False
    h = L // 2
    B = (1 << w) + 128
    Dnt = (1 << w) + 4
    Dt = 2 * B + 4
    return (2 * h * B * B + (1 << 19) < (1 << 31)) and (
        (h - 2) * Dnt * Dnt + 2 * Dt * Dnt + (1 << 19) < (1 << 31)
    )


def check_cuda_config(cfg: MsmConfig) -> None:
    """The CUDA kernels implement all seven curves with 8- to 13-bit limbs
    (``WIDTHS``), plain or pair compressed, each with or without GLV
    (the convert, the scan and the four pair kernels have GLV modes for
    every curve). Karatsuba selects a TPU product for the same function,
    so it is accepted where the JAX package builds it (``karatsuba_ok``)
    and refused where that package refuses it. Anything else raises before
    a launch."""
    if cfg.word_size not in WIDTHS or cfg.curve.name not in CURVE_IDS:
        raise NotImplementedError(
            f"CUDA kernels support word_size {min(WIDTHS)} to {max(WIDTHS)} on {', '.join(CURVE_IDS)}; "
            f"got curve={cfg.curve.name} word_size={cfg.word_size}"
        )
    if cfg.karatsuba and not karatsuba_ok(cfg):
        raise NotImplementedError(
            f"karatsuba=True is not built for {cfg.curve.name} at word_size "
            f"{cfg.word_size} (odd limb count or int32 column budget)"
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


def library_of(width: int) -> str:
    """The library that serves a limb width: "default" for 13 (or "narrow"
    inside ``narrow_at_13``), "narrow" for the other widths of WIDTHS."""
    if width not in WIDTHS:
        raise NotImplementedError(f"no CUDA kernels for word_size {width}")
    return "narrow" if width in NARROW_WIDTHS or _narrow_13 else "default"


def width_flags(width: int) -> list[str]:
    """The compile flags of the library that serves a limb width (none for
    the default 13; NARROW_FLAGS for 8 to 12)."""
    return NARROW_FLAGS if library_of(width) == "narrow" else []


def library_path(width: int = 13) -> Path:
    """The library that serves a limb width: ``<hash>/`` for 13,
    ``<hash>/narrow/`` for 8 to 12."""
    out = BUILD_ROOT / source_hash()
    return (out if library_of(width) == "default" else out / "narrow") / "libmsm_tpu_torch.so"


@contextlib.contextmanager
def narrow_at_13():
    """Within the block, width 13 launches run on the narrow library (its
    W = 13 rows of csrc/widths.cuh): a check's hook, which holds the narrow
    library's outputs at 13 against the default library's limb for limb.
    No wrapper sends 13 to the narrow library outside it."""
    global _narrow_13
    _narrow_13 = True
    try:
        yield
    finally:
        _narrow_13 = False


def build(width: int = 13) -> Path:
    """Compile the library that serves a limb width if this source hash
    has none yet; returns its path. The compiler's register/spill report
    goes to ``build.log`` beside the library."""
    flags = [*NVCC_FLAGS, *width_flags(width)]
    so = library_path(width)
    if so.exists():
        return so
    out_dir = so.parent
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    cus = [p for p in sources() if p.suffix == ".cu"]
    t_all = time.perf_counter()

    def compile_one(src: Path) -> tuple[Path, str, int, float]:
        obj = out_dir / (src.stem + ".o")
        t0 = time.perf_counter()
        r = subprocess.run(
            [nvcc, *flags, "-c", str(src), "-o", str(obj)],
            capture_output=True, text=True,
        )
        return obj, r.stdout + r.stderr, r.returncode, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(cus)) as pool:
        results = list(pool.map(compile_one, cus))
    failed = [f"nvcc failed on {o.stem}.cu:\n{log}" for o, log, rc, _ in results if rc != 0]
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = out_dir / f"lib.{os.getpid()}.so"
    r = subprocess.run(
        [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
         "-o", str(tmp), *[str(o) for o, _, _, _ in results]],
        capture_output=True, text=True,
    )
    if r.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{r.stderr}")
    (out_dir / "build.log").write_text("".join(log for _, log, _, _ in results))
    (out_dir / "compile_seconds.json").write_text(json.dumps({
        "wall": round(time.perf_counter() - t_all, 1), "cpu_count": os.cpu_count(),
        **{o.stem + ".cu": round(s, 1) for o, _, _, s in results}}))
    os.replace(tmp, so)
    return so


def load(width: int = 13) -> ctypes.CDLL:
    """Build if needed and load the library that serves a limb width (once
    per process and library; another thread asking for the same library
    waits for the build)."""
    name = library_of(width)
    with _locks[name]:
        if name not in _libs:
            lib = ctypes.CDLL(str(build(width)))
            for entry, argtypes in SIGNATURES.items():
                fn = getattr(lib, entry)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]


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


def launch(name: str, *args, width: int) -> None:
    """Call C entry ``name`` of the library that serves limb width ``width``
    (the config's ``word_size``) on the current stream. Tensors pass as
    device pointers, ints as they are; the width (but to the histogram,
    which has no field) and the stream are appended."""
    lib = load(width)
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    if name not in FIELDLESS:
        cargs.append(width)
    with torch.cuda.device(dev):
        err = getattr(lib, name)(*cargs, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
