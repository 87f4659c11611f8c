"""Profiling — the port of ``msm_tpu/utils/profiling.py``:

- ``trace(path)``: ``torch.profiler`` over a block (host and, where there
  is one, CUDA activity), written to ``path`` as a Chrome trace (the JAX
  package's is ``jax.profiler``'s);
- ``stage_timings(n, cfg)``: the cuZK pipeline's stages at n points, each
  the median of synchronized runs after a warm run, with the JAX report's
  keys, and the nominal field multiplications per second;
- ``mont_variant_bench(cfg)``: the field multipliers side by side (the
  lazy Montgomery product, Barrett, the point-add kernel per product, the
  eager and nSafe products at word sizes 13 to 16), each the median of
  synchronized runs after a warm run.
"""

from __future__ import annotations

import contextlib
import statistics
import time

import torch


@contextlib.contextmanager
def trace(path):
    """Profile the block; write its Chrome trace to ``path``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(path))


def _median_ms(fn, device: torch.device, reps: int) -> float:
    """Median of ``reps`` runs of fn, each ended by a synchronize (ms),
    after one warm run (the library build and first launches stay out)."""

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn()
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def stage_timings(n: int, cfg, seed: int = 0, device="cuda", reps: int = 5) -> dict:
    """Per-stage times of the cuZK pipeline at n sampled points: the
    convert (K2), the scalar decomposition (under GLV the split first), one
    subtask's boundary prefixes, the S window sums from boundary prefixes
    (one subtask's, repeated S times), and the whole window-sum pipeline.
    Above ``CHUNK_MAX`` points the stages run on the first chunk and the
    pipeline on every chunk."""
    from msm_tpu_torch.bench import sample_inputs
    from msm_tpu_torch.models import common, cuzk
    from msm_tpu_torch.models.geometry import pick_geometry
    from msm_tpu_torch.ops.curve import PointBatch, get_curve_ctx
    from msm_tpu_torch.ops.scan import bucket_boundary_prefix, window_sum_from_pe

    dev = torch.device(device)
    ec = get_curve_ctx(cfg)
    pts, ks = sample_inputs(n, cfg.curve, seed)
    arrays = common.pad_inputs(pts, ks, cfg)
    first = cuzk.chunk_slices(arrays[0].shape[0])[0]
    geom = pick_geometry(first.stop, cfg)
    xd, yd, sd = (torch.from_numpy(a).to(dev) for a in arrays)
    x0, y0, s0 = xd[first], yd[first], sd[first]
    packed = common.prepare_points(cfg, x0, y0)
    keys, signs = cuzk.decompose_scalars(s0, cfg)
    S = cfg.num_subtasks

    def prefix():
        return bucket_boundary_prefix(ec, packed, keys[:1], signs[:1], cfg.num_buckets, geom.num_rows, 1)

    pe = prefix()
    pe_s = PointBatch(*(a.expand(S, *a.shape[1:]).contiguous() for a in pe))
    t = {
        "convert_points": _median_ms(lambda: common.prepare_points(cfg, x0, y0), dev, reps),
        "decompose_scalars": _median_ms(lambda: cuzk.decompose_scalars(s0, cfg), dev, reps),
        "boundary_prefix_per_subtask": _median_ms(prefix, dev, reps),
        f"window_sum_x{S}_batched": _median_ms(lambda: window_sum_from_pe(ec, pe_s), dev, reps),
        "full_pipeline": _median_ms(
            lambda: cuzk.chunked_window_sums(cuzk.chunks((xd, yd, sd), dev), cfg, geom), dev, reps),
    }
    # nominal work: the plain pipeline's mixed-add products at this window
    # size (the JAX report's count), so GLV and compression read as a
    # higher rate rather than a different denominator
    nominal_subtasks = -(-(cfg.curve.order_bits + 1) // cfg.chunk_size)
    return {
        "n": n,
        "curve": cfg.curve.name,
        "num_subtasks": S,
        "geometry": {"num_rows": geom.num_rows, "bpr_threads": geom.bpr_threads},
        "stages_ms": t,
        "field_muls_per_sec_nominal": round(nominal_subtasks * n * 13 / (t["full_pipeline"] / 1e3)),
    }


def mont_variant_bench(cfg=None, batch: int = 1 << 16, reps: int = 5, device="cuda", seed: int = 0) -> dict:
    """Times of the field multipliers on ``batch`` lanes of random limbs on
    ``device`` (ms, median of ``reps``): ``mont_torch_ms``, the lazy
    ``FieldCtx.mont_mul``; ``barrett_torch_ms``, ``barrett_mul`` on
    canonical inputs; ``cuda_add_ms``, kernel 1 (``cuda_curve.point_add``,
    its plain twin on the CPU) on six random coordinate tensors, and
    ``mont_cuda_ms_per_mul_equiv``, that time over the complete addition's
    12 Montgomery products; ``mont_eager_w{w}_ms`` and
    ``mont_nsafe_w{w}_ms``, ``mont_mul_eager`` and ``mont_mul_nsafe`` at
    word sizes 13 to 16. Everything but kernel 1 is plain PyTorch. Default
    config: BN254 at 13 bits; ``seed`` draws the random limbs."""
    import dataclasses

    import numpy as np

    from msm_tpu_torch.ops import cuda_curve
    from msm_tpu_torch.ops.field import get_field_ctx, mont_mul_eager, mont_mul_nsafe
    from msm_tpu_torch.params import DEFAULT_CONFIG

    cfg = cfg or DEFAULT_CONFIG
    dev = torch.device(device)
    f = get_field_ctx(cfg)
    rng = np.random.default_rng(seed)

    def rand(w: int, nw: int) -> torch.Tensor:
        return torch.from_numpy(rng.integers(0, (1 << w) - 1, size=(batch, nw)).astype(np.int32)).to(dev)

    a, b = rand(cfg.word_size, cfg.num_words), rand(cfg.word_size, cfg.num_words)
    out = {"batch": batch, "word_size": cfg.word_size, "num_words": cfg.num_words}
    out["mont_torch_ms"] = _median_ms(lambda: f.mont_mul(a, b), dev, reps)
    ca, cb = f.canonical(a), f.canonical(b)
    out["barrett_torch_ms"] = _median_ms(lambda: f.barrett_mul(ca, cb), dev, reps)
    coords = [rand(cfg.word_size, cfg.num_words) for _ in range(6)]
    before = cuda_curve.point_add.launches
    out["cuda_add_ms"] = add_ms = _median_ms(lambda: cuda_curve.point_add(cfg, *coords), dev, reps)
    if dev.type == "cuda" and cuda_curve.point_add.launches <= before:
        raise AssertionError("kernel 1 was not launched")
    out["mont_cuda_ms_per_mul_equiv"] = add_ms / 12  # complete addition: 12 products
    for w in (13, 14, 15, 16):
        cw = dataclasses.replace(cfg, word_size=w)
        aw, bw = rand(w, cw.num_words), rand(w, cw.num_words)
        out[f"mont_eager_w{w}_ms"] = _median_ms(lambda: mont_mul_eager(cw, aw, bw), dev, reps)
        out[f"mont_nsafe_w{w}_ms"] = _median_ms(lambda: mont_mul_nsafe(cw, aw, bw), dev, reps)
    return out
