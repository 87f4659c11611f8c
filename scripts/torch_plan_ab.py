#!/usr/bin/env python3
"""The serving plan's words call of two checkouts in one process: this
checkout's ``msm_tpu_torch`` and another one's (for example the parent
commit, unpacked with ``git archive`` into a directory that .gitignore
lists), timed in turns on the same points and scalar words.

    python3 scripts/torch_plan_ab.py OTHER_ROOT [--rounds 6] [--calls 5]

Both checkouts must hold the same kernel sources (their source hashes are
compared): the other checkout's wrappers launch this checkout's library, so
only the Python call path between the caller and the kernels differs. Each
package is imported with all its modules, and its modules are put back into
``sys.modules`` before its turn, so the imports that its functions make at
call time find its own code.

Cells: the plain and the GLV compressed configs at 2^20 and 2^16 points
(1024 random bases tiled; uniform scalars as np.uint16 words [n, 16]). Per
round and cell, each checkout makes ``--calls`` words calls, the order of
the two checkouts alternating from round to round. Prints each turn's call
times (host clock, ms; a call ends in the copy of its result), then per
cell and checkout the median of all its calls, and checks both checkouts'
results against the folded oracle. Needs one GPU.
"""

from __future__ import annotations

import argparse
import importlib
import pkgutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
CELLS = [(20, "plain"), (20, "glv_compressed"), (16, "plain"), (16, "glv_compressed")]
SEED = 7


def load_tree(root: Path) -> dict:
    """Import the package of ``root`` with every submodule; returns its
    modules by name, and leaves ``sys.modules`` without any of them."""
    for name in [m for m in sys.modules if m.split(".")[0] == "msm_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, str(root))
    try:
        pkg = importlib.import_module("msm_tpu_torch")
        if Path(pkg.__file__).resolve().parent != (root / "msm_tpu_torch").resolve():
            raise RuntimeError(f"imported {pkg.__file__}, not the package of {root}")
        for info in pkgutil.walk_packages(pkg.__path__, "msm_tpu_torch."):
            if not info.name.endswith(".__main__"):
                importlib.import_module(info.name)
    finally:
        sys.path.remove(str(root))
    return {m: sys.modules.pop(m) for m in list(sys.modules) if m.split(".")[0] == "msm_tpu_torch"}


def use(mods: dict):
    """Make ``mods`` the package that imports resolve to; returns it."""
    for name in [m for m in sys.modules if m.split(".")[0] == "msm_tpu_torch"]:
        del sys.modules[name]
    sys.modules.update(mods)
    return mods["msm_tpu_torch"]


def config(mods: dict, kind: str, n: int):
    params = mods["msm_tpu_torch.params"]
    if kind == "plain":
        return params.pick_config(n)
    return params.MsmConfig(curve=params.BN254, compress=True, glv=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--calls", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    trees = {"this": load_tree(ROOT), "other": load_tree(args.other.resolve())}
    hashes = {}
    for tree, mods in trees.items():
        use(mods)
        hashes[tree] = mods["msm_tpu_torch.ops._build"].source_hash()
    if hashes["this"] != hashes["other"]:
        raise RuntimeError(f"the kernel sources differ: {hashes}")
    this = use(trees["this"])
    lib = trees["this"]["msm_tpu_torch.ops._build"].load()
    trees["other"]["msm_tpu_torch.ops._build"]._lib = lib
    bench = trees["this"]["msm_tpu_torch.bench"]
    cv = trees["this"]["msm_tpu_torch.oracle.pyecc"].Curve(this.BN254)

    rng = np.random.default_rng(SEED)
    inputs, plans = {}, {}
    for logn, kind in CELLS:
        n = 1 << logn
        if logn not in inputs:
            pts, _ = bench.sample_inputs(n, this.BN254, SEED)
            words = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.uint16)
            words[:, 15] = rng.integers(0, this.BN254.order >> 240, size=n)
            inputs[logn] = (pts, words, bench.folded_oracle(pts[: min(n, bench.NBASE)], words))
        pts, words, want = inputs[logn]
        for tree, mods in trees.items():
            pkg = use(mods)
            plans[tree, logn, kind] = plan = pkg.plan(pts, config=config(mods, kind, n), device="cuda")
            ok = cv.eq(plan.jpoint(words), want)
            print(f"2^{logn} {kind} {tree}: folded oracle "
                  f"{'bit-exact' if ok else 'DIFFERS'}", flush=True)
            if not ok:
                raise AssertionError(f"2^{logn} {kind} {tree}: differs from the folded oracle")
            for _ in range(2):
                plan.jpoint(words)  # warm

    times = {key: [] for key in plans}
    for rnd in range(args.rounds):
        order = list(trees) if rnd % 2 == 0 else list(reversed(trees))
        for logn, kind in CELLS:
            words = inputs[logn][1]
            for tree in order:
                use(trees[tree])
                plan = plans[tree, logn, kind]
                walls = []
                for _ in range(args.calls):
                    t0 = time.perf_counter()
                    plan.jpoint(words)
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t0) * 1e3)
                times[tree, logn, kind] += walls
                print(f"round {rnd} 2^{logn} {kind} {tree}: " + ", ".join(f"{w:.2f}" for w in walls), flush=True)
    for logn, kind in CELLS:
        med = {tree: statistics.median(times[tree, logn, kind]) for tree in trees}
        print(f"2^{logn} {kind} words call, median of {args.rounds * args.calls} (ms): "
              + ", ".join(f"{t} {m:.2f}" for t, m in med.items())
              + f"; this - other {med['this'] - med['other']:+.2f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
