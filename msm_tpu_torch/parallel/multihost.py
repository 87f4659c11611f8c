"""Several processes, one shard each, on ``torch.distributed`` — the
PyTorch port of ``msm_tpu/parallel/multihost.py``.

Every process (a rank) runs the same program on the same points and
scalars: it uploads only its own shard's rows (``shard_rows``), runs stages
1-4 on its device, and an ``all_gather`` collects every rank's KB-size
window sums; each rank then merges them with the point-add tree of
``parallel/sharded`` and finishes with kernel 7, so every rank returns the
same point.

    from msm_tpu_torch.parallel.multihost import init_multihost, run_msm_multihost
    init_multihost()                       # torchrun's environment
    res = run_msm_multihost(points, scalars)

Launch with ``torchrun --nproc-per-node G script.py`` (``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``), or give
``init_multihost`` the coordinator's ``host:port``, the number of processes
and this one's index. The backend is the caller's choice: ``"nccl"`` (the
default) for one card a rank, rank r on ``cuda:{LOCAL_RANK}`` (else
``r`` mod the visible cards); ``"gloo"`` on the CPU, or for ranks that
share a card, which NCCL refuses. Under NCCL the gather runs on the device
(``all_gather_into_tensor``), under gloo on the window sums copied to the
host.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from msm_tpu_torch.models import common, cuzk
from msm_tpu_torch.models.geometry import MsmGeometry, pick_geometry
from msm_tpu_torch.oracle.pyecc import IDENTITY, JPoint
from msm_tpu_torch.params import MsmConfig, pick_config
from msm_tpu_torch.parallel.sharded import merge_shards, shard_count, shard_window_sums, split_rows


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> None:
    """Join the process group: at ``tcp://{coordinator_address}`` with the
    given size and rank, or from torchrun's environment when the address
    is None. ``backend`` defaults to ``"nccl"``, which needs a CUDA device
    per rank; under NCCL this process's current device becomes its own."""
    backend = backend or "nccl"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("backend nccl needs a CUDA device; pass backend='gloo' to run on the CPU")
    if coordinator_address is None:
        init_method = "env://"
    elif num_processes is None or process_id is None:
        raise ValueError("a coordinator address needs num_processes and process_id")
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init_method, world_size=-1 if num_processes is None else num_processes,
                            rank=-1 if process_id is None else process_id)
    if backend == "nccl":
        torch.cuda.set_device(rank_device())


def local_device_count() -> int:
    """The CUDA devices this process sees."""
    return torch.cuda.device_count()


def rank_device() -> torch.device:
    """This rank's card: ``cuda:{LOCAL_RANK}``, else the rank mod the
    visible cards; ``RuntimeError`` without one."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the plain twins")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def global_mesh(device=None) -> list[torch.device]:
    """Every rank's device, by rank (rank r holds shard r), as each rank
    names it: ``device`` or this rank's card, gathered from all ranks."""
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, str(torch.device(device) if device is not None else rank_device()))
    return [torch.device(n) for n in names]


def shard_rows(device, *host_arrays) -> tuple[torch.Tensor, ...]:
    """This rank's rows of the full host arrays [n, ...] (n a multiple of
    the world size), uploaded to ``device``: no rank uploads another's
    rows."""
    own = split_rows(host_arrays, dist.get_world_size())[dist.get_rank()]
    return tuple(torch.as_tensor(a, device=device) for a in own)


def all_window_sums(ws: torch.Tensor) -> list[torch.Tensor]:
    """This rank's window sums [S, 3, L] -> every rank's, by rank, on this
    rank's device: on the device under NCCL, through the host under
    gloo."""
    world = dist.get_world_size()
    if dist.get_backend() == "nccl":
        out = torch.empty((world, *ws.shape), dtype=ws.dtype, device=ws.device)
        dist.all_gather_into_tensor(out, ws.contiguous())
        return list(out)
    host = ws.cpu()
    out = [torch.empty_like(host) for _ in range(world)]
    dist.all_gather(out, host)
    return [t.to(ws.device) for t in out]


def multihost_window_sums(rows, cfg: MsmConfig, geom: MsmGeometry, device) -> torch.Tensor:
    """This rank's (x, y, scalar words) rows (``shard_rows``) -> the MSM's
    Montgomery window sums [S, 3, L] on ``device``, the same on every
    rank: this rank's stages 1-4, the gather, the tree."""
    local = shard_window_sums([rows], cfg, geom, [device])[0]
    return merge_shards(all_window_sums(local), cfg, device)


def run_msm_multihost(
    points: list[tuple[int, int]],
    scalars: list[int],
    config: MsmConfig | None = None,
    device=None,
) -> JPoint:
    """End-to-end MSM over every rank of the process group (each calls it
    with the same points and scalars) -> the same oracle JPoint on every
    rank. ``device`` is this rank's (default: its card). Needs
    ``init_multihost`` first; the world size must be a power of two."""
    if len(points) == 0:
        return IDENTITY
    config = config or pick_config(len(points))
    device = torch.device(device) if device is not None else rank_device()
    common.check_config(config, device)
    d = shard_count(range(dist.get_world_size()))
    arrays = common.pad_inputs(points, scalars, config, multiple=16 * d)
    geom = pick_geometry(min(arrays[0].shape[0] // d, cuzk.CHUNK_MAX), config)
    ws = multihost_window_sums(shard_rows(device, *arrays), config, geom, device)
    return common.std_ints_to_jpoint(*cuzk.msm_point_from_ws(ws, config), config)
