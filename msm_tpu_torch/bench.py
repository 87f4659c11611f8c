"""The port's benchmark: one JSON line in the format of the repository's
``bench.py``, measured on a CUDA device unless ``--device cpu`` is given.

    python -m msm_tpu_torch.bench --size 20              # the MSM, inputs on the device
    python -m msm_tpu_torch.bench --size 20 --glv --compress
    python -m msm_tpu_torch.bench --plan 4 --size 20     # the serving plan
    python -m msm_tpu_torch.bench --batched 4 --size 16  # the batched model
    python -m msm_tpu_torch.bench --sharded 2 --size 20  # 1 shard against 2
    torchrun --nproc-per-node 2 -m msm_tpu_torch.bench --sharded 2 --multihost

Inputs (``sample_inputs``): 1024 random points tiled to n and uniform
scalars, from ``--seed``, the same points and scalars as the JAX package's
sampler. Results are held to the folded oracle: the scalars of the points
that share a base are summed mod the order, and the oracle MSM runs over
the 1024 bases (exact for tiled points). The oracle gate is ``bench.py``'s:
verify when ``--verify`` is given or n <= 2^20.

- Default mode: the inputs are padded and uploaded once; each timed rep is
  one ``cuzk_msm_point`` (convert, window sums, Horner, one copy of its
  three rows) and the export to a point. ``value`` is the least of
  ``--reps``. ``--auto`` adds the GLV + compressed config as a candidate
  once it passes a 2^14 check against the oracle; a candidate whose result
  differs from the oracle is discarded, and the run fails if none is left.
- ``--plan B``: ``call_ms`` is a plan call on u16 words [n, 16]
  (``np.uint16``), ``batch_ms_per_instance`` ``run_batch`` of B word sets
  (set b: the scalars rolled by b), ``program_ms`` the window sums and the
  Horner with the words already unpacked on the device, and
  ``batch_program_ms_per_instance`` that for the B sets at once.
- ``--batched B``: ``batched_window_sums`` over B stacked instances on the
  device (instance b: the scalars rolled by b), then one Horner launch over
  the B ladders and one copy.
- ``--sharded D``: the sharded MSM (``parallel/sharded``) with 1 and with D
  shards, each shard's rows uploaded to its device once; a rep is the
  shards' window sums, the point-add tree, the Horner launch and one copy.
  The shards go round-robin onto the visible cards (``--device cpu``: all
  on the CPU). ``detail`` has a row for each shard count: ``shards``,
  ``devices`` (distinct devices used), ``wall_ms`` (least of ``--reps``)
  and ``efficiency`` = (t_1 / t_D) / devices. With fewer devices than
  shards the line says ``"plumbing_only": true`` and that row's
  efficiency (and ``value``) is null: the shards then share a device, and
  no scaling is measured.
- ``--sharded D --multihost``: every rank of a ``torch.distributed`` group
  of D processes runs this command (torchrun's environment, or
  ``--coordinator host:port --num-processes D --process-id r``;
  ``--backend`` ``nccl``, the default, or ``gloo`` for the CPU or ranks
  that share a card): each uploads and reduces its own shard, the window
  sums are gathered and merged by the tree on every rank; each rank logs
  its result, rank 0 alone prints the line (one row: D shards, the
  distinct devices of the ranks; efficiency null, as no one-shard run is
  timed in the group).

Every timed call has one untimed call before it (the library's build at
first use, the first launches). Each line carries ``device`` (the card's name, or ``cpu``), ``config`` and
``verified``; each rep's time and the peak device memory go to stderr.
``vs_baseline`` is against ``bench.py``'s estimate of the reference
(WebGPU cuZK, ~2 s at 2^20).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from msm_tpu_torch.models import common, cuzk
from msm_tpu_torch.models.batched import batched_window_sums
from msm_tpu_torch.models.geometry import pick_geometry
from msm_tpu_torch.oracle import best_msm
from msm_tpu_torch.oracle.pyecc import Curve
from msm_tpu_torch.params import BN254, CURVES, MsmConfig, pick_config
from msm_tpu_torch.parallel.sharded import split_rows, window_sums_of_shards

BASELINE_MS = 2000.0  # bench.py's estimate of the reference at 2^20
NBASE = 1024


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def sample_inputs(n: int, curve=BN254, seed: int = 0):
    """n points tiled from min(n, 1024) random ones, and n uniform scalars
    below the order (256 random bits each, from numpy's ``default_rng(seed
    + 1)``, reduced)."""
    cv = Curve(curve)
    nbase = min(n, NBASE)
    base = [cv.to_affine(p) for p in cv.sample_points(nbase, seed=seed)]
    raw = np.random.default_rng(seed + 1).bytes(32 * n)
    ks = [int.from_bytes(raw[i : i + 32], "little") % curve.order for i in range(0, 32 * n, 32)]
    return [base[i % nbase] for i in range(n)], ks


def fold_scalars(words: np.ndarray, nbase: int, order: int) -> list[int]:
    """Scalar words [n, W] (u16 values in any integer dtype) of points
    tiled from nbase bases (point i is base i mod nbase) -> each base's
    scalar sum mod the order: word columns summed in int64, then nbase x W
    sums to ints."""
    w = np.asarray(words).astype(np.int64) & 0xFFFF
    w = np.pad(w, ((0, -len(w) % nbase), (0, 0)))  # zero scalars to a multiple of nbase rows
    sums = w.reshape(-1, nbase, w.shape[1]).sum(axis=0)
    return [sum(int(v) << (16 * j) for j, v in enumerate(row)) % order for row in sums]


def folded_oracle(base, words: np.ndarray, curve=BN254):
    """The exact MSM of points tiled from ``base`` under scalar words
    [n, W]: the oracle MSM over the bases with the folded scalars."""
    return best_msm(base, fold_scalars(words, len(base), curve.order), curve=curve)


def _config(args, n: int) -> MsmConfig:
    curve = CURVES[args.curve]
    cfg = MsmConfig(curve=curve, chunk_size=args.chunk) if args.chunk else pick_config(n, curve=curve)
    return dataclasses.replace(cfg, glv=args.glv or cfg.glv, compress=args.compress or cfg.compress,
                               karatsuba=args.karatsuba or cfg.karatsuba)


def _label(cfg: MsmConfig) -> str:
    return "+".join(k for k, on in (("glv", cfg.glv), ("compress", cfg.compress), ("karatsuba", cfg.karatsuba))
                    if on) or "base"


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def _log_peak(dev: torch.device, what: str) -> None:
    if dev.type == "cuda":
        log(f"{what}: peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")


def _warm(fn, what: str) -> None:
    """One untimed call of fn (the library's build at first use, the first
    launches)."""
    t0 = time.perf_counter()
    fn()
    log(f"{what}: first run (library build and first launches) {time.perf_counter() - t0:.1f} s")


def _min_ms(fn, reps: int, what: str) -> tuple[float, object]:
    """(least wall-clock in ms, last result) of ``reps`` calls of fn; each
    call must end in a copy to the host (a synchronize)."""
    times, out = [], None
    for r in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
        log(f"{what}: rep {r} {times[-1]:.3f} ms")
    return min(times), out


def _line(dev, cfg, metric: str, value: float, verified: bool, **extra) -> None:
    print(json.dumps({
        "metric": metric, "value": round(value, 2), "unit": "ms",
        "vs_baseline": round(BASELINE_MS / value, 3), "config": _label(cfg), "verified": verified,
        **extra, "device": _device_name(dev),
    }), flush=True)


def _check(cv: Curve, got, want, what: str) -> None:
    if not cv.eq(got, want):
        sys.exit(f"[bench] {what} does not match the CPU oracle")


def _msm_ms(dev, cfg, arrays, reps: int, what: str):
    """(least ms, result JPoint) of the default mode's reps for one config:
    ``cuzk_msm_point`` on inputs uploaded once, and the export."""
    xd, yd, sd = (torch.from_numpy(a).to(dev) for a in arrays)
    n = arrays[0].shape[0]
    geom = pick_geometry(min(n, cuzk.CHUNK_MAX), cfg)

    def run():
        return common.std_ints_to_jpoint(*cuzk.cuzk_msm_point(xd, yd, sd, cfg, geom), cfg)

    _warm(run, what)
    _reset_peak(dev)
    out = _min_ms(run, reps, what)
    _log_peak(dev, what)
    return out


def _self_check(dev, cfg: MsmConfig, seed: int, logn: int = 14) -> bool:
    """The config's MSM of 2^logn sampled points against the oracle."""
    pts, ks = sample_inputs(1 << logn, cfg.curve, seed=seed)
    arrays = common.pad_inputs(pts, ks, cfg)
    xd, yd, sd = (torch.from_numpy(a).to(dev) for a in arrays)
    geom = pick_geometry(arrays[0].shape[0], cfg)
    got = common.std_ints_to_jpoint(*cuzk.cuzk_msm_point(xd, yd, sd, cfg, geom), cfg)
    return Curve(cfg.curve).eq(got, folded_oracle(pts[:NBASE], arrays[2][: len(pts)], cfg.curve))


def bench_msm(args, dev) -> None:
    n = 1 << args.size
    cfg = _config(args, n)
    candidates = [(_label(cfg), cfg)]
    if args.auto and not (args.glv or args.compress or args.chunk):
        opt = dataclasses.replace(cfg, glv=True, compress=True)
        if _self_check(dev, opt, seed=7):
            candidates.append((_label(opt), opt))
            log(f"{_label(opt)} self-verified vs oracle at 2^14")
        else:
            log(f"{_label(opt)} MISMATCH at 2^14 — not measured")
    t0 = time.perf_counter()
    pts, ks = sample_inputs(n, cfg.curve, args.seed)
    arrays = common.pad_inputs(pts, ks, cfg)
    log(f"setup {time.perf_counter() - t0:.1f} s; n=2^{args.size}, device={_device_name(dev)}")
    measured = []
    for name, c in candidates:
        ms, res = _msm_ms(dev, c, arrays, args.reps, name)
        log(f"{name}: {ms:.3f} ms")
        measured.append((ms, name, c, res))
    verified = False
    if args.verify or args.size <= 20:
        cv = Curve(cfg.curve)
        want = folded_oracle(pts[:NBASE], arrays[2][:n], cfg.curve)
        for entry in sorted(measured, key=lambda t: t[0]):
            if cv.eq(entry[3], want):
                log(f"{entry[1]} verified vs CPU oracle")
                verified = True
                break
            log(f"{entry[1]} MISMATCH vs oracle — discarding its number")
            measured.remove(entry)
        if not measured:
            sys.exit("[bench] every candidate config mismatched the CPU oracle")
    ms, name, c, _ = min(measured, key=lambda t: t[0])
    s_nominal = MsmConfig(curve=c.curve, chunk_size=c.chunk_size).num_subtasks
    _line(dev, c, f"{c.curve.name}_msm_2^{args.size}_wall_clock", ms, verified,
          field_muls_per_sec_nominal=round(s_nominal * n * 13 / (ms / 1e3)))


def _rolled_words(ks: list[int], B: int) -> list[np.ndarray]:
    """B scalar sets as u16 words [n, 16]: set b is the scalars rolled by
    b (point j takes scalar (j - b) mod n)."""
    words = common.ints_to_u16_array(ks)
    return [np.roll(words, b, axis=0) for b in range(B)]


def bench_plan(args, dev) -> None:
    import msm_tpu_torch
    from msm_tpu_torch.models.plan import scalars_to_words

    B, n = args.plan, 1 << args.size
    cfg = _config(args, n)
    pts, ks = sample_inputs(n, cfg.curve, args.seed)
    t0 = time.perf_counter()
    plan = msm_tpu_torch.plan(pts, config=cfg, device=dev)
    _reset_peak(dev)
    log(f"plan build (serialize + upload + convert) {time.perf_counter() - t0:.2f} s, "
        f"{len(plan.tables)} table(s)")
    sets = _rolled_words(ks, B)
    verify = args.verify or args.size <= 20
    cv = Curve(cfg.curve)
    wants = [folded_oracle(pts[:NBASE], w, cfg.curve) for w in sets] if verify else []
    _warm(lambda: plan.jpoint(sets[0]), "plan call (words)")
    call_ms, got = _min_ms(lambda: plan.jpoint(sets[0]), args.reps, "plan call (words)")
    if verify:
        _check(cv, got, wants[0], "the plan call")
    # words already unpacked on the device: the window sums and the Horner
    dwords = [torch.from_numpy(scalars_to_words(w, cfg, n, plan.N)).to(dev) for w in sets]

    def program(ws):
        return cuzk.msm_jpoints_from_ws([plan.window_sums(w.__getitem__) for w in ws], cfg)

    _warm(lambda: program(dwords[:1]), "plan program")
    program_ms, got = _min_ms(lambda: program(dwords[:1]), args.reps, "plan program (words on the device)")
    if verify:
        _check(cv, got[0], wants[0], "the plan program")
    extra = {"call_ms": round(call_ms, 2)}
    value = call_ms
    if B > 1:
        _warm(lambda: plan.run_batch(sets), f"plan run_batch B={B}")
        batch_ms, got = _min_ms(lambda: plan.run_batch(sets), args.reps, f"plan run_batch B={B}")
        prog_ms, got_prog = _min_ms(lambda: program(dwords), args.reps, f"plan program B={B}")
        if verify:
            for b in range(B):
                _check(cv, got[b], wants[b], f"plan run_batch instance {b}")
                _check(cv, got_prog[b], wants[b], f"plan program instance {b}")
            log(f"all {B} batch instances verified vs CPU oracle")
        extra["batch_ms_per_instance"] = round(batch_ms / B, 2)
        value = min(call_ms, batch_ms / B)
    extra["program_ms"] = round(program_ms, 2)
    if B > 1:
        extra["batch_program_ms_per_instance"] = round(prog_ms / B, 2)
    _log_peak(dev, "plan calls")
    _line(dev, cfg, f"{cfg.curve.name}_plan_msm_2^{args.size}_per_instance", value, verify, **extra)


def bench_batched(args, dev) -> None:
    B, n = args.batched, 1 << args.size
    cfg = _config(args, n)
    pts, ks = sample_inputs(n, cfg.curve, args.seed)
    x, y, s = common.pad_inputs(pts, ks, cfg)
    N = x.shape[0]
    sets = [s.copy() for _ in range(B)]  # instance b: the n scalars rolled by b, padding 0
    for b in range(B):
        sets[b][:n] = np.roll(s[:n], b, axis=0)
    xb, yb = (torch.from_numpy(np.ascontiguousarray(np.broadcast_to(a, (B, *a.shape)))).to(dev) for a in (x, y))
    sb = torch.from_numpy(np.stack(sets)).to(dev)
    geom = pick_geometry(min(N, cuzk.CHUNK_MAX), cfg)

    def run():
        return cuzk.msm_jpoints_from_ws(list(batched_window_sums(xb, yb, sb, cfg, geom)), cfg)

    _warm(run, f"batched B={B}")
    _reset_peak(dev)
    t, got = _min_ms(run, args.reps, f"batched B={B}")
    _log_peak(dev, "batched")
    verify = args.verify or args.size <= 20
    if verify:
        cv = Curve(cfg.curve)
        for b in range(B):
            _check(cv, got[b], folded_oracle(pts[:NBASE], sets[b][:n], cfg.curve), f"batched instance {b}")
        log(f"all {B} instances verified vs CPU oracle")
    log(f"B={B} x 2^{args.size}: {t:.1f} ms total, {t / B:.2f} ms/instance")
    _line(dev, cfg, f"{cfg.curve.name}_batched_msm_{B}x2^{args.size}_per_instance", t / B, verify)


def _shard_devices(dev: torch.device, d: int) -> list[torch.device]:
    """d shards round-robin on the visible cards, or all on the CPU."""
    if dev.type == "cpu":
        return [dev] * d
    return [torch.device("cuda", i % torch.cuda.device_count()) for i in range(d)]


def _sharded_line(cfg, metric: str, rows: list, verified: bool, dev) -> None:
    plumbing = any(r["devices"] < r["shards"] for r in rows)
    print(json.dumps({
        "metric": metric, "value": rows[-1]["efficiency"], "unit": "scaling_efficiency",
        "plumbing_only": plumbing, "detail": rows, "config": _label(cfg), "verified": verified,
        "device": _device_name(dev),
    }), flush=True)


def bench_sharded(args, dev) -> None:
    D, n = args.sharded, 1 << args.size
    if D & (D - 1):
        sys.exit(f"[bench] --sharded {D}: the shard count must be a power of two")
    if args.multihost:
        return bench_multihost(args, dev)
    cfg = _config(args, n)
    pts, ks = sample_inputs(n, cfg.curve, args.seed)
    arrays = common.pad_inputs(pts, ks, cfg, multiple=16 * D)
    verify = args.verify or args.size <= 20
    want = folded_oracle(pts[:NBASE], arrays[2][:n], cfg.curve) if verify else None
    rows, t1 = [], None
    for d in sorted({1, D}):
        devices = _shard_devices(dev, d)
        geom = pick_geometry(min(arrays[0].shape[0] // d, cuzk.CHUNK_MAX), cfg)
        shards = [tuple(torch.as_tensor(a, device=sd) for a in part) for part, sd in zip(split_rows(arrays, d), devices)]

        def run():
            ws = window_sums_of_shards(shards, cfg, geom, devices)
            return common.std_ints_to_jpoint(*cuzk.msm_point_from_ws(ws, cfg), cfg)

        _warm(run, f"sharded D={d}")
        t, got = _min_ms(run, args.reps, f"sharded D={d}")
        if verify:
            _check(Curve(cfg.curve), got, want, f"sharded D={d}")
        t1 = t1 or t
        used = len(set(devices))
        rows.append({"shards": d, "devices": used, "wall_ms": round(t, 3),
                     "efficiency": round(t1 / t / used, 4) if used == d else None})
    if verify:
        log(f"every shard count verified vs CPU oracle on {_device_name(dev)}")
    _sharded_line(cfg, f"{cfg.curve.name}_msm_2^{args.size}_sharded_{D}x", rows, verify, dev)


def bench_multihost(args, dev) -> None:
    import torch.distributed as dist

    from msm_tpu_torch.parallel import multihost

    multihost.init_multihost(args.coordinator, args.num_processes, args.process_id, backend=args.backend)
    try:
        rank, world = dist.get_rank(), dist.get_world_size()
        if world != args.sharded:
            sys.exit(f"[bench] --multihost measures the whole group: pass --sharded {world}")
        device = dev if dev.type == "cpu" else multihost.rank_device()
        n = 1 << args.size
        cfg = _config(args, n)
        pts, ks = sample_inputs(n, cfg.curve, args.seed)
        arrays = common.pad_inputs(pts, ks, cfg, multiple=16 * world)
        geom = pick_geometry(min(arrays[0].shape[0] // world, cuzk.CHUNK_MAX), cfg)
        mine = multihost.shard_rows(device, *arrays)

        def run():
            ws = multihost.multihost_window_sums(mine, cfg, geom, device)
            return common.std_ints_to_jpoint(*cuzk.msm_point_from_ws(ws, cfg), cfg)

        _warm(run, f"rank {rank}")
        times = []
        for _ in range(args.reps):
            dist.barrier()
            t0 = time.perf_counter()
            got = run()
            times.append((time.perf_counter() - t0) * 1e3)
        verify = args.verify or args.size <= 20
        if verify:
            _check(Curve(cfg.curve), got, folded_oracle(pts[:NBASE], arrays[2][:n], cfg.curve),
                   f"rank {rank} of {world}")
        xy = "identity" if got.is_identity() else " ".join(hex(v) for v in Curve(cfg.curve).to_affine(got))
        log(f"rank {rank} of {world} on {device} ({args.backend or 'nccl'}): result {xy}; "
            f"verified {verify}; reps ms {', '.join(f'{t:.3f}' for t in times)}")
        used = len(set(multihost.global_mesh(device)))
        if rank == 0:
            rows = [{"shards": world, "devices": used, "wall_ms": round(min(times), 3), "efficiency": None}]
            _sharded_line(cfg, f"{cfg.curve.name}_msm_2^{args.size}_multihost_{world}ranks", rows, verify, dev)
    finally:
        dist.destroy_process_group()


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m msm_tpu_torch.bench", description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=20, help="log2 MSM size")
    ap.add_argument("--curve", default="bn254", help=f"one of {', '.join(CURVES)} (CUDA: all, with --glv and --compress)")
    ap.add_argument("--seed", type=int, default=0, help="the inputs' seed")
    ap.add_argument("--chunk", type=int, default=0, help="window size (0: the config's)")
    ap.add_argument("--glv", action="store_true", help="GLV endomorphism config")
    ap.add_argument("--compress", action="store_true", help="pair-compressed config")
    ap.add_argument("--karatsuba", action="store_true", help="Karatsuba config (no CUDA kernels)")
    ap.add_argument("--verify", action="store_true", help="hold the result to the oracle at any size")
    ap.add_argument("--timings", action="store_true", help="also print the stage timings to stderr")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--auto", action="store_true", help="also measure the GLV + compressed candidate")
    ap.add_argument("--batched", type=int, default=0, metavar="B", help="batched mode: B instances")
    ap.add_argument("--plan", type=int, default=0, metavar="B", help="serving-plan mode: B scalar sets")
    ap.add_argument("--sharded", type=int, default=0, metavar="D", help="sharded mode: 1 against D shards")
    ap.add_argument("--multihost", action="store_true",
                    help="with --sharded D: one shard a rank of a torch.distributed group of D processes")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="--multihost: the group's address (default: torchrun's environment)")
    ap.add_argument("--num-processes", type=int, default=None, help="--multihost with --coordinator: D")
    ap.add_argument("--process-id", type=int, default=None, help="--multihost with --coordinator: this rank")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="--multihost: nccl (default; a card a rank) or gloo (CPU, or ranks sharing a card)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def require_device(device) -> torch.device:
    """``device`` as a torch.device; exits non-zero when it is a CUDA
    device and there is none (no fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit(f"no CUDA device for --device {device}; pass --device cpu to run the plain twins")
    return dev


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    dev = require_device(args.device)
    if args.timings:
        from msm_tpu_torch.utils.profiling import stage_timings

        log("stage timings: " + json.dumps(stage_timings(1 << args.size, _config(args, 1 << args.size),
                                                          args.seed, dev)))
    if args.sharded:
        bench_sharded(args, dev)
    elif args.plan:
        bench_plan(args, dev)
    elif args.batched:
        bench_batched(args, dev)
    else:
        bench_msm(args, dev)


if __name__ == "__main__":
    main()
