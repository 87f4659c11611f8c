#!/usr/bin/env python3
"""The sharded MSM across the cards of one host (msm_tpu_torch.parallel):
correctness and wall-clock, from the repository root on a machine with
several GPUs (four on the measured host):

    python3 scripts/torch_sharded_cards.py

Prints the cards' name and power limit, builds the kernels, then for the
BN254 plain MSM of 2^20 points (chip_smoke.py's inputs: 1024 bases tiled,
seeded scalars, the folded oracle): 1, 2 and 4 shards with every shard on
cuda:0, then on cuda:0..3 round-robin, each result bit-exact, each wall the
median of 7 (shard rows uploaded to their cards once; a run is the shards'
window sums, the point-add tree on cuda:0, the Horner launch and one copy);
a plan's words call on one card against plan_sharded over every card, 7
each in turn; the bench's ``--sharded <cards> --size 20 --verify`` line;
and the bench's ``--multihost`` run with one NCCL rank a card (LOCAL_RANK
set a rank), every rank's result and timings.
"""

import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import msm_tpu_torch  # noqa: E402
from msm_tpu_torch.models import common, cuzk  # noqa: E402
from msm_tpu_torch.models.geometry import pick_geometry  # noqa: E402
from msm_tpu_torch.ops import _build  # noqa: E402
from msm_tpu_torch.oracle.pyecc import Curve  # noqa: E402
from msm_tpu_torch.params import BN254  # noqa: E402
from msm_tpu_torch.parallel.sharded import split_rows, window_sums_of_shards  # noqa: E402


def main() -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print("cards", torch.cuda.device_count(), "torch", torch.__version__, flush=True)
    t = time.time()
    _build.build(13)
    _build.load(13)
    print("build", round(time.time() - t, 1), flush=True)
    cv = Curve(BN254)
    base, pts, ks = cs.sample_msm(1 << 20)
    want = cs.folded_oracle(base, ks)
    cfg, _ = cs.msm_path("plain", 1 << 20)
    arrays = common.pad_inputs(pts, ks, cfg, multiple=64)
    n = arrays[0].shape[0]
    count = torch.cuda.device_count()
    for label, devs in [("one card", lambda d: [torch.device("cuda", 0)] * d),
                        ("cards", lambda d: [torch.device("cuda", i % count) for i in range(d)])]:
        for d in (1, 2, 4):
            devices = devs(d)
            geom = pick_geometry(min(n // d, cuzk.CHUNK_MAX), cfg)
            shards = [tuple(torch.as_tensor(a, device=sd) for a in part)
                      for part, sd in zip(split_rows(arrays, d), devices)]

            def run():
                ws = window_sums_of_shards(shards, cfg, geom, devices)
                return common.std_ints_to_jpoint(*cuzk.msm_point_from_ws(ws, cfg), cfg)

            if not cv.eq(run(), want):
                raise AssertionError(f"2^20 plain D={d} on {label} differs from the oracle")
            walls = []
            for _ in range(7):
                for dv in set(devices):
                    torch.cuda.synchronize(dv)
                t0 = time.perf_counter()
                run()
                walls.append((time.perf_counter() - t0) * 1e3)
            print(f"2^20 plain D={d} on {label} {sorted(set(map(str, devices)))}: bit-exact; wall_ms median of 7 = "
                  f"{statistics.median(walls):.2f} (runs {', '.join(f'{w:.2f}' for w in walls)})", flush=True)
    words = common.ints_to_u16_array(ks)
    plan = msm_tpu_torch.plan(pts, config=cfg)
    splan = msm_tpu_torch.plan_sharded(pts, devices=[f"cuda:{i}" for i in range(count)], config=cfg)
    if not splan(words) == plan(words) == cv.to_affine(want):
        raise AssertionError("a plan call differs from the oracle")
    single, sharded = [], []
    for _ in range(7):
        t0 = time.perf_counter()
        plan(words)
        single.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        splan(words)
        sharded.append((time.perf_counter() - t0) * 1e3)
    print(f"plan words call 2^20: {count} cards {statistics.median(sharded):.2f} ms vs one "
          f"{statistics.median(single):.2f} (medians of 7, in turn)", flush=True)
    del plan, splan
    r = subprocess.run([sys.executable, "-m", "msm_tpu_torch.bench", "--sharded", str(count), "--size", "20",
                        "--verify", "--reps", "5"], capture_output=True, text=True, timeout=600, cwd=ROOT)
    print("bench --sharded", count, "rc", r.returncode, r.stdout.strip(), r.stderr[-1500:], flush=True)
    port = cs._free_port()
    env = {**os.environ, "NCCL_SOCKET_IFNAME": "lo", "GLOO_SOCKET_IFNAME": "lo"}
    procs = [subprocess.Popen([sys.executable, "-m", "msm_tpu_torch.bench", "--sharded", str(count), "--multihost",
                               "--coordinator", f"localhost:{port}", "--num-processes", str(count),
                               "--process-id", str(i), "--size", "20", "--verify", "--reps", "5"],
                              env={**env, "LOCAL_RANK": str(i)}, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for i in range(count)]
    for i, proc in enumerate(procs):
        out, err = proc.communicate(timeout=600)
        print(f"nccl rank {i}: rc {proc.returncode} {out.strip()}",
              [line for line in err.splitlines() if "rank" in line or "Error" in line][-3:], flush=True)


if __name__ == "__main__":
    main()
