"""One rank of the two-process test of msm_tpu_torch.parallel.multihost.

Run as: python _torch_multihost_worker.py <rank> <world size> <port>

The rank joins a gloo process group at localhost:<port> through
``init_multihost`` and runs ``run_msm_multihost`` on the CPU over
tests/_multihost_worker.py's inputs (512 points tiled from 32, scalars from
numpy seed 6, chunk 8); it prints its affine result for the parent test.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from msm_tpu_torch.oracle.pyecc import Curve
    from msm_tpu_torch.params import BN254, MsmConfig
    from msm_tpu_torch.parallel.multihost import init_multihost, run_msm_multihost

    init_multihost(coordinator_address=f"localhost:{port}", num_processes=world, process_id=rank, backend="gloo")
    assert (dist.get_rank(), dist.get_world_size(), dist.get_backend()) == (rank, world, "gloo")
    cv = Curve(BN254)
    n = 512
    base = [cv.to_affine(p) for p in cv.sample_points(32, seed=5)]
    pts = [base[i % len(base)] for i in range(n)]
    rng = np.random.default_rng(6)
    ks = [int.from_bytes(rng.bytes(32), "little") % BN254.order for _ in range(n)]
    res = run_msm_multihost(pts, ks, config=MsmConfig(curve=BN254, chunk_size=8), device="cpu")
    x, y = cv.to_affine(res)
    print(f"MULTIHOST_RESULT {rank} {x} {y}", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
