#!/usr/bin/env python3
"""Two builds of msm_tpu_torch's kernels in one process: this checkout's
library and another checkout's (for example the parent commit, unpacked
with ``git archive`` into a directory that .gitignore lists), timed in turns
on the same inputs at the 2^20 MSM's shapes (the pair-value kernels at the
TPU rule's compressed shape, 4 subtasks of 1024 steps over 1024 lanes),
with the SASS of both builds compared kernel by kernel.

    python3 scripts/torch_lib_ab.py OTHER_ROOT [--rounds 5]

The other checkout's library is built by its own ``msm_tpu_torch.ops._build``
(in a subprocess, into its own ``build/``). This checkout's wrappers launch
through ``_build.load()``; the script swaps the loaded library between the
two builds, so of the entry points timed here (point add, convert, scan,
row offsets, point total, Horner ladder, suffix and forward pair products,
backward pair emission, all three in their GLV modes too, blocked
reduction's phase 1, the scaled convert's two-table mode, Fermat
inversion, emission + scan and its GLV mode, the GLV convert and the GLV
scan)
only those whose C signature is the
same in both trees are timed, or this tree's with the curve index before
the stream where the other tree's has none (the other build is then
called without it: a tree from before the kernels took a curve, which ran
BN254 only); the others are named and skipped. The inputs are BN254's.
Both builds' outputs must be equal bit for bit (every kernel writes
canonical limbs, and the two builds sum in the same order).

Prints, per round, kernel and build, the ms per call (CUDA events over calls
queued behind a spin kernel, as ``chip_smoke.py`` times kernels), the
builds in alternating order; then the medians; then, per kernel present in
both builds, whether its SASS (with the out-of-line functions it calls) is
identical, else both instruction counts and the first difference; a
kernel is matched by its name, its field (a kernel of no field is
BN254's) and its library's limb width, so a kernel that became a template
over the field is matched with its BN254 instance, and the 12-bit
library's instances (``<hash>/w12/``, built with -DMSM_LIMB_BITS=12) only
with the other tree's 12-bit ones, where it has them. Needs the CUDA
toolkit and one GPU.
"""

from __future__ import annotations

import argparse
import ast
import ctypes
import dataclasses
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke as cs  # noqa: E402
from msm_tpu_torch.ops import _build  # noqa: E402
from torch_sass_mix import sass  # noqa: E402

#: wrapper -> its C entry point
KERNELS = {"point_add": "msm_point_add", "convert_pack": "msm_convert", "scan_rows": "msm_scan",
           "row_offsets": "msm_row_offsets", "point_total": "msm_point_total", "horner": "msm_horner",
           "pair_suffix": "msm_pair_suffix", "pair_forward": "msm_pair_forward",
           "pair_backward": "msm_pair_backward", "pair_suffix_glv": "msm_pair_suffix_glv",
           "pair_forward_glv": "msm_pair_forward_glv", "pair_backward_glv": "msm_pair_backward_glv",
           "bpr_phase1": "msm_bpr_phase1", "convert_pack_scaled": "msm_convert_scaled",
           "mont_pow": "msm_mont_pow", "emit_scan": "msm_emit_scan", "emit_scan_glv": "msm_emit_scan_glv",
           "convert_pack_glv": "msm_convert_glv", "scan_rows_glv": "msm_scan_rows_glv"}


def other_library(root: Path) -> tuple[Path, dict[str, str]]:
    """Build the other checkout's kernels with its own build code; returns
    the library and its C entry points' signatures (as text)."""
    code = ("from msm_tpu_torch.ops import _build; print({k: repr(v) for k, v in "
            "_build.SIGNATURES.items()}); print(_build.build())")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                         capture_output=True, text=True).stdout.strip().splitlines()
    return Path(out[-1]), ast.literal_eval(out[-2])


def _without_curve(sig: list) -> list:
    """A signature of this tree less its curve index (before the stream)."""
    return sig[:-2] + sig[-1:]


class OtherLibrary:
    """The other build's entry points behind this tree's calls: an entry
    whose other signature lacks this tree's curve index gets the call
    without it."""

    def __init__(self, so: Path, sigs: dict[str, list], names) -> None:
        self._lib = ctypes.CDLL(str(so))
        self._drop = set()
        for name in names:
            fn = getattr(self._lib, name)
            fn.argtypes = sigs[name]
            fn.restype = ctypes.c_int
            if len(sigs[name]) < len(_build.SIGNATURES[name]):
                self._drop.add(name)

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name in self._drop:
            return lambda *args: fn(*args[:-2], args[-1])
        return fn


def cases(rng, kern) -> dict:
    """Wrapper arguments at the plain 2^20 MSM's shapes: G = 4 subtasks,
    R = 16384 lanes of C = 64 steps, 32769 buckets, S = 16 windows, the
    convert over 2^20 coordinates below p; the pair-value kernels over the
    table of 256 real points with planted doubling and infinity pairs at
    G = 4, C = 1024, R = 1024 (the suffix products too), the backward
    emission on this build's forward products and their inverse; the GLV
    forward and suffix products and backward emission over the GLV table of
    128 points and their phi images at the same shape; the scaled convert's
    two tables (x R and beta x R) over 2^20 coordinates below p; the
    blocked reduction's phase 1 over the
    16 windows' buckets at 512 lanes (Bl = 64), with planted rows; then
    the Fermat inversion over 16 x 2048 lanes (e = p - 2), the emission +
    scan on the suffix products of the pair streams above and their inverse
    (both modes), the GLV convert over 2^20 coordinates below p and the GLV
    scan at the GLV 2^20 shape (G = 4, C = 128, R = 16384)."""
    from msm_tpu_torch.oracle.pyecc import Curve
    from msm_tpu_torch.ops.cuda_convert import pack_canonical
    from msm_tpu_torch.params import BN254, MsmConfig, pick_config

    dev = torch.device("cuda")
    base_cfg = MsmConfig(curve=BN254)
    aff = [Curve(BN254).to_affine(p) for p in Curve(BN254).sample_points(256, seed=cs.SEED)]
    base = torch.stack([torch.from_numpy(cs._mont(v, base_cfg)) for v in zip(*aff)]).to(dev)
    cfg = pick_config(1 << 20)
    G, C, R, S, NB = 4, 64, 1 << 14, cfg.num_subtasks, cfg.num_buckets
    n = C * R

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    tab = torch.cat([pack_canonical(torch.from_numpy(cs._rand_fe(rng, (n,), cfg)), cfg)
                     for _ in range(2)], dim=-1).to(dev)
    perm = np.stack([rng.permutation(n).reshape(R, C).T for _ in range(G)]).astype(np.int32)
    rows = cs._curve_points(rng, (G, R), cfg, base, dev)
    table = torch.cat([pack_canonical(base[i], base_cfg) for i in range(2)], dim=-1)
    pair_in = [MsmConfig(curve=BN254, compress=True), table,
               *map(t, cs._pair_stream(rng, 4, 1024, 1024, table.shape[0]))]
    glv_table = cs._glv_table(aff[:128], base_cfg).to(dev)
    glv_in = [MsmConfig(curve=BN254, compress=True, glv=True), glv_table,
              *map(t, cs._glv_pair_stream(rng, 4, 1024, 1024, glv_table.shape[0]))]
    out = {
        "point_add": [cfg, *(t(cs._rand_fe(rng, (G * NB,), cfg)) for _ in range(6))],
        "convert_pack": [cfg, *map(t, cs._coord_words(rng, n, cfg.curve.modulus))],
        "scan_rows": [cfg, tab, t(perm), t(rng.integers(0, 2, size=perm.shape, dtype=np.int32))],
        "row_offsets": [cfg, *(a.transpose(1, 2).contiguous() for a in rows)],
        "point_total": [cfg, *cs._curve_points(rng, (S, NB - 1), cfg, base, dev)],
        "horner": [cfg, *(t(cs._rand_fe(rng, (S,), cfg)) for _ in range(3)), cfg.chunk_size],
        "pair_suffix": pair_in,
        "pair_forward": pair_in,
        "pair_backward": cs._backward_args(kern, pair_in),
        "pair_suffix_glv": glv_in,
        "pair_forward_glv": glv_in,
        "pair_backward_glv": cs._backward_args(kern, glv_in),
        "convert_pack_scaled": [cfg, *map(t, cs._coord_words(rng, n, cfg.curve.modulus)), None,
                                cs._scaled_modes(cfg)[1][2], False],
        "bpr_phase1": [cfg, *map(t, cs._bpr_buckets(rng, (S, (NB - 1) // 512, 512), cfg))],
    }
    glv_cfg = dataclasses.replace(cfg, glv=True)
    out.update({
        "mont_pow": [pair_in[0], t(cs._pow_lanes(rng, 16, 2048, cfg)), BN254.modulus - 2],
        "emit_scan": cs._emit_scan_args(kern, pair_in),
        "emit_scan_glv": cs._emit_scan_args(kern, glv_in),
        "convert_pack_glv": [glv_cfg, *map(t, cs._coord_words(rng, n, cfg.curve.modulus))],
        "scan_rows_glv": [glv_cfg, *cs._glv_scan_inputs(rng, n, G, R, glv_cfg, dev)],
    })
    return out


def kernel_key(mangled: str, width: int = 13) -> str:
    """A kernel's name, field and limb width from its mangled name and its
    library's width (the names are the same in every width's library):
    ``k_scan`` for ``_Z6k_scanPKi...`` and for
    ``_ZN3msm6k_scanINS_7FpBn254EEEv...`` (BN254's instance),
    ``k_scan<FpPallas>`` for Pallas', ``k_scan<FpPallas>@w12`` for Pallas'
    in the 12-bit library. The field is read whole, by its length prefix."""
    name = next(m.group(2)[:int(m.group(1))] for m in re.finditer(r"(\d+)(k_\w+)", mangled)
                if len(m.group(2)) >= int(m.group(1)))
    found = re.search(r"(\d+)(Fp\w+)", mangled)
    field = found.group(2)[:int(found.group(1))] if found else "FpBn254"
    key = name if field == "FpBn254" else f"{name}<{field}>"
    return key if width == 13 else f"{key}@w{width}"


def compare_sass(mine: Path, other: Path) -> None:
    """Every kernel in both trees' libraries, by kernel_key: the 13-bit
    objects beside each library, and the 12-bit ones under ``w12/`` where
    both trees built them."""
    pairs = [(obj, other / obj.name, 13) for obj in sorted(mine.glob("*.o"))]
    pairs += [(obj, other / "w12" / obj.name, 12) for obj in sorted((mine / "w12").glob("*.o"))]
    for obj, theirs, width in pairs:
        if not theirs.exists():
            continue
        a, b = ({kernel_key(k, width): v for k, v in sass(o).items()} for o in (obj, theirs))
        for fn in sorted(set(a) & set(b)):
            if a[fn] == b[fn]:
                print(f"sass {obj.name} {fn}: identical ({len(a[fn])} instructions)")
                continue
            i = next((k for k, (x, y) in enumerate(zip(a[fn], b[fn])) if x != y),
                     min(len(a[fn]), len(b[fn])))
            diff = sum(x != y for x, y in zip(a[fn], b[fn])) + abs(len(a[fn]) - len(b[fn]))
            print(f"sass {obj.name} {fn}: differs ({len(a[fn])} vs {len(b[fn])} instructions, "
                  f"{diff} positions differ; first at {i}: "
                  f"{a[fn][i] if i < len(a[fn]) else '-'} | {b[fn][i] if i < len(b[fn]) else '-'})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    other_so, other_sigs = other_library(args.other.resolve())
    sigs = {}
    for entry, sig in _build.SIGNATURES.items():
        for cand in (sig, _without_curve(sig)):
            if other_sigs.get(entry) == repr(cand):
                sigs[entry] = cand
    names = [k for k, entry in KERNELS.items() if entry in sigs]
    for k in KERNELS:
        if k not in names:
            print(f"{k}: its C entry point differs between the two trees; not timed")
    libs = {"this": _build.load(), "other": OtherLibrary(other_so, sigs, [KERNELS[k] for k in names])}
    kern = cs._kernels()
    inputs = cases(np.random.default_rng(cs.SEED), kern)
    times: dict[tuple[str, str], list[float]] = {}
    for rnd in range(args.rounds):
        order = ("this", "other") if rnd % 2 == 0 else ("other", "this")
        for name in names:
            outs = {}
            for side in order:
                _build._libs[13] = libs[side]
                outs[side], ms = cs._kernel_ms(lambda: kern[name][0](*inputs[name]), 3)
                times.setdefault((name, side), []).append(ms)
                print(f"round {rnd} {name:12s} {side:5s} {ms:.4f} ms", flush=True)
            if not all(torch.equal(x, y) for x, y in zip(outs["this"], outs["other"])):
                raise AssertionError(f"{name}: the two builds' outputs differ")
    _build._libs[13] = libs["this"]
    for name in names:
        a, b = (statistics.median(times[(name, s)]) for s in ("this", "other"))
        print(f"median {name:12s} this {a:.4f} ms  other {b:.4f} ms  ({a / b:.3f} x other)")
    compare_sass(_build.library_path().parent, other_so.parent)
    return 0


if __name__ == "__main__":
    sys.exit(main())
