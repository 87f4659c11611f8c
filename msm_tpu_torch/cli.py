"""Command line of the port — the counterpart of ``msm_tpu/cli.py``:

    python -m msm_tpu_torch msm     --size 16     # the MSM on the card
    python -m msm_tpu_torch cpu     --size 12     # the CPU oracle MSM
    python -m msm_tpu_torch verify  --size 12     # the card against the oracle
    python -m msm_tpu_torch bench   --size 20     # python -m msm_tpu_torch.bench
    python -m msm_tpu_torch profile --size 16     # stage timings
    python -m msm_tpu_torch variants --size 16    # the field multipliers' times

Each prints the JSON of the JAX package's command. ``msm``, ``verify``,
``profile`` and ``variants`` take ``--device`` (default ``cuda``; ``cpu``
runs the kernels' plain twins) and exit non-zero when it names a CUDA
device that is not there; ``cpu`` runs on the host alone, for every
curve. ``bench`` hands its arguments to ``msm_tpu_torch.bench.main`` in
this process. The inputs are ``msm_tpu_torch.bench.sample_inputs``'s
from ``--seed`` (``variants``: its random limbs).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _config(args):
    from msm_tpu_torch.params import CURVES, MsmConfig

    return MsmConfig(curve=CURVES[args.curve], glv=args.glv, compress=args.compress)


def cmd_msm(args) -> None:
    import msm_tpu_torch
    from msm_tpu_torch.bench import require_device, sample_inputs

    require_device(args.device)
    cfg = _config(args)
    pts, ks = sample_inputs(1 << args.size, cfg.curve, args.seed)
    t0 = time.time()
    msm_tpu_torch.run_gpu_msm(pts, ks, config=cfg, device=args.device)  # builds and warms
    warm = time.time() - t0
    t0 = time.time()
    out = msm_tpu_torch.run_gpu_msm(pts, ks, config=cfg, device=args.device)
    dt = time.time() - t0
    x, y = out if out is not None else (0, 0)
    print(json.dumps({"x": str(x), "y": str(y), "elapsed_ms": round(dt * 1e3, 2),
                      "first_run_ms": round(warm * 1e3, 2)}))


def cmd_cpu(args) -> None:
    from msm_tpu_torch import cpu_msm
    from msm_tpu_torch.bench import sample_inputs
    from msm_tpu_torch.oracle.pyecc import Curve
    from msm_tpu_torch.params import CURVES

    curve = CURVES[args.curve]
    pts, ks = sample_inputs(1 << args.size, curve, args.seed)
    t0 = time.time()
    res = cpu_msm(pts, ks, curve=curve)
    dt = time.time() - t0
    x, y = Curve(curve).to_affine(res) if not res.is_identity() else (0, 0)
    print(json.dumps({"x": str(x), "y": str(y), "elapsed_ms": round(dt * 1e3, 2)}))


def cmd_verify(args) -> None:
    import msm_tpu_torch
    from msm_tpu_torch.bench import require_device, sample_inputs
    from msm_tpu_torch.oracle.pyecc import Curve

    require_device(args.device)
    cfg = _config(args)
    cv = Curve(cfg.curve)
    pts, ks = sample_inputs(1 << args.size, cfg.curve, args.seed)
    got = msm_tpu_torch.run_gpu_msm(pts, ks, config=cfg, device=args.device)
    want = msm_tpu_torch.cpu_msm(pts, ks, curve=cfg.curve)
    ok = (got is None and want.is_identity()) or (not want.is_identity() and got == cv.to_affine(want))
    print(json.dumps({"size": args.size, "curve": args.curve, "bit_exact": ok}))
    if not ok:
        sys.exit(1)


def cmd_profile(args) -> None:
    from msm_tpu_torch.bench import require_device
    from msm_tpu_torch.utils.profiling import stage_timings

    require_device(args.device)
    print(json.dumps(stage_timings(1 << args.size, _config(args), seed=args.seed, device=args.device), indent=2))


def cmd_variants(args) -> None:
    from msm_tpu_torch.bench import require_device
    from msm_tpu_torch.params import CURVES, MsmConfig
    from msm_tpu_torch.utils.profiling import mont_variant_bench

    require_device(args.device)
    cfg = MsmConfig(curve=CURVES[args.curve])
    print(json.dumps(mont_variant_bench(cfg, batch=1 << args.size, device=args.device, seed=args.seed), indent=2))


COMMANDS = {"msm": cmd_msm, "cpu": cmd_cpu, "verify": cmd_verify, "profile": cmd_profile, "variants": cmd_variants}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m msm_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in (*COMMANDS, "bench"):
        if name == "bench":
            sub.add_parser(name, add_help=False, help="python -m msm_tpu_torch.bench with these arguments")
            continue
        p = sub.add_parser(name)
        p.add_argument("--size", type=int, default=16, help="log2 input size")
        p.add_argument("--curve", default="bn254",
                       help="any of params.CURVES (CUDA: all seven, plain, compress and glv)")
        p.add_argument("--seed", type=int, default=0)
        if name not in ("cpu", "variants"):
            p.add_argument("--glv", action="store_true", help="GLV endomorphism config (a=0 curves)")
            p.add_argument("--compress", action="store_true", help="pair-compressed config")
        if name != "cpu":
            p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["bench"]:
        from msm_tpu_torch import bench

        bench.main(argv[1:])
        return
    args = parser().parse_args(argv)
    COMMANDS[args.cmd](args)
