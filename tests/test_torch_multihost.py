"""msm_tpu_torch.parallel.multihost with two real processes on the CPU (a
gloo group at a localhost port; tests/_torch_multihost_worker.py), as
tests/test_multihost.py runs the JAX package's: both ranks return the same
point, the oracle's. And the bench's sharded line on the CPU
(``--sharded 2 --device cpu --verify``): a row for 1 and for 2 shards, and
``plumbing_only`` since both shards share the CPU."""

import json
import os
import socket
import subprocess
import sys

import numpy as np

import _torch_helpers  # noqa: F401  (one torch thread)
from msm_tpu_torch import bench
from msm_tpu_torch.oracle import best_msm
from msm_tpu_torch.oracle.pyecc import Curve
from msm_tpu_torch.params import BN254

CV = Curve(BN254)
WORKER = os.path.join(os.path.dirname(__file__), "_torch_multihost_worker.py")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_processes_gloo():
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), "2", str(port)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=ROOT) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
            outs.append(out)
    finally:  # never leave a peer blocked in the group
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("MULTIHOST_RESULT"):
                _, rank, x, y = line.split()
                results[int(rank)] = (int(x), int(y))
    assert set(results) == {0, 1}, outs
    assert results[0] == results[1]
    base = [CV.to_affine(p) for p in CV.sample_points(32, seed=5)]
    pts = [base[i % len(base)] for i in range(512)]
    rng = np.random.default_rng(6)
    ks = [int.from_bytes(rng.bytes(32), "little") % BN254.order for _ in range(512)]
    assert results[0] == CV.to_affine(best_msm(pts, ks))


def test_bench_sharded_line(capsys):
    bench.main(["--sharded", "2", "--size", "6", "--device", "cpu", "--reps", "1", "--verify"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == {"metric", "value", "unit", "plumbing_only", "detail", "config", "verified", "device"}
    assert out["metric"] == "bn254_msm_2^6_sharded_2x" and out["verified"] is True and out["device"] == "cpu"
    assert out["plumbing_only"] is True and out["value"] is None
    one, two = out["detail"]
    assert (one["shards"], one["devices"], one["efficiency"]) == (1, 1, 1.0)
    assert (two["shards"], two["devices"], two["efficiency"]) == (2, 1, None)
    assert one["wall_ms"] > 0 and two["wall_ms"] > 0
