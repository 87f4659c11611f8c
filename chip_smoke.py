#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (msm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit, builds the thirteen CUDA kernels,
   their six GLV modes and the convert kernel's run-time-constant mode, all
   generic over the field, with every instance for the six other curves,
   from msm_tpu_torch/csrc at 13-bit limbs, and prints the build time and
   each translation unit's compile seconds (with the host's
   os.cpu_count()); every kernel's ptxas report (registers, frame, spills)
   and SASS size for every curve, failing if a SASS holds an out-of-line
   call (report_plain_builds), prints before the curves phase, its SASS
   read by a thread (cuobjdump at nice 19) beside the steps before it; the
   narrow library's build (the same sources
   with -DMSM_LIMB_BITS=0: the limb width 8 to 12 read at run time from
   csrc/widths.cuh) starts after it and runs beside the steps below, in a
   process of its own at nice 19 on half the host's cores (BUILD_NARROW;
   NarrowBuild, whose thread then runs cuobjdump over its objects), and
   step 19 waits for it;
2. holds every kernel against its plain PyTorch twin on the card, on the
   same inputs (a twin of at most CPU_TWIN_ELEMS input elements, such as
   the Horner ladder's serial chain, on copies of them on the CPU, where
   its small ops cost less than launches; several such twins at a time in
   worker processes, the host's cores but two, while the kernels are
   timed, each group of checks compared when its twins return: settle,
   here and in steps 15-17 and 19), at a small shape and at the shape the 2^20
   MSM gives it
   (the pair kernels: the compressed 2^20 shape of models/geometry.py's
   rule, with planted doubling and infinity pairs; bpr_phase1: the blocked
   reduction of the 2^20 MSM's buckets), as exact integers after
   canonicalization (points summed in
   another order: by cross-multiplication), timing both with CUDA events
   (the kernels enqueued behind a spin kernel, so host overhead stays out),
   and computes each kernel's bound at that shape (the larger of its
   multiply-adds over the card's integer rate and its bytes over the HBM
   rate: 32 B per field element, the narrowest integer per key or index,
   1 bit per flag) and, for the histogram, the time of torch.bincount;
   then the point add, histogram and point total at the other shapes that
   the naive and blocked paths give them, the histogram on skewed keys
   (half of each row 0, one row in the top window's narrow range) and over
   65536 buckets (more counters than a block's shared memory holds), the
   row offsets at R = 8, 1024 and 8192 lanes and at R = 16384 over 8 and
   16 subtasks (4 and 8 lanes per thread), the scan, the point total and
   the Horner ladder at the 2^16 shapes (G = 4, C = 8, R = 8192; 20 x 4096
   points; S = 20, chunk 13), the Horner kernel over the window sums'
   two-point folds (16 ladders at chunk 15, 20 at chunk 12), each Horner
   time beside the depth of its chain in products, the scan timed alone
   and just after a histogram or a row-offsets launch, the convert kernel
   at 2^16 points and on 2^20 coordinates anywhere in [0, 2^256) (most of
   them >= p), the emission + scan at the compressed 2^16 shape, the suffix
   products at the compressed 2^16 shape, the Fermat kernel over 16 x
   1024, 16 x 2048 and 16 x 4096 lanes (one, p - 1, zero and negated
   balanced lanes planted) and for e = 0, 1, p - 2 and a 1000-bit e, and
   the forward products and backward emission (kernels 10 and 11) at the
   compressed 2^20 shape as well as the TPU rule's, and the blocked
   reduction's phase 1 at the 2^16 shape (G20 T256 Bl16; every shape of it
   with planted negated rows, identity buckets and buckets equal to the
   running sum);
3. runs compress_pairs on the card at the TPU rule's compressed 2^20 shape
   (R = 1024 lanes, C = 1024 steps, 4 subtasks) and, under GLV, at the GLV
   compressed 2^20 shape (G = 8, C = 1024, R = 2048) over points, their
   phi images and planted pairs, and checks every pair sum and infinity
   flag against the oracle and that each run launched only its path's
   kernels;
4. runs small edge MSMs (edge scalars, duplicate points, P and -P under one
   scalar, identity results, n = 0) on the plain, pair-compressed and naive
   paths;
5. drives each path at n = 2^20 with every launch counter reset just before
   it: the main path (run_gpu_msm, BN254, pick_config), the compressed path
   (MsmConfig(BN254, compress=True), its geometry and stage-3 device time
   by kernel printed on a line of its own) and the naive Pippenger
   (compute_msm_naive, 8-bit unsigned windows); checks that every kernel of
   the path ran, that the kernels it must not reach did not, and that the
   result is bit-exact (1024 distinct base points tiled to n, scalars folded
   per base point mod r, oracle MSM over the bases); then all three at
   n = 2^16 against the oracle MSM over all 2^16 points;
6. times each end-to-end MSM (warm, median of 3), its stages (with the
   bytes uploaded), its peak device memory, and, under torch.profiler, its
   device time by kernel, its kernel time (busy less copies) and the
   device's idle share;
7. at n = 2^20 drives the reference-shaped stage 4 (bucket_accumulate, then
   bucket_reduce_blocked through bpr_phase1): its 16 window sums equal the
   telescoped ones on the same points, and Horner over them is bit-exact;
8. the GLV configuration (msm_tpu msm --glv): the six GLV modes (convert,
   scan, pair suffix, emission + scan, forward products, backward emission:
   three-coordinate table rows x, beta x, y, the x of an element chosen by
   bit 1 of its flags) against their twins at the GLV 2^20 and 2^16 shapes
   (the convert also on coordinates >= p; the pair modes over a table of
   points and their phi images with planted doubling, infinity and
   equal-x-across-halves pairs); the GLV
   plain path (pick_config with glv=True: c = 16, S = 8) and the GLV
   compressed path (compress=True, glv=True) driven like the paths above
   (edge MSMs with lambda, r - lambda, negative halves and P beside phi(P);
   bit-exact at 2^20 and 2^16; timings with the scalar split as a stage of
   its own); each path checked to run the GLV modes and not the plain ones;
9. the convert kernel with its x constants at run time (convert_pack_scaled:
   an overridden x constant, two tables sharing y, the triple table with an
   overridden first constant, the plain default, the triple table with the
   GLV constants) against its twin at 2^20 points below p and on
   coordinates anywhere in [0, 2^256), then driven in its five modes with
   the counters reset just before;
10. the serving plan (msm_tpu_torch.plan) on the plain, compressed, GLV
   and GLV compressed configs at 2^20 and 2^16, on step 5's points,
   scalars and oracle: the build by stage (serialize points, upload,
   convert), an ints call and a call on u16 words [n, 16], three more word
   calls and a run_batch of 4 distinct word sets (each against its folded
   oracle), all bit-exact, each with the counters reset just before (a
   plan call launches its path's kernels but no convert: paths plan_*);
   one line per config and size with the words call's wall median of 5,
   the ints call's median of 3, the words call by stage (host_pack,
   upload and its MiB, unpack, glv_split, decompose, window_sums, tail),
   one profiled words call's device busy time, idle share and kernel ms,
   peak device memory, and run_batch's wall; then the batched model
   (compute_msm_batched, 4 instances of 2^16 points, plain: bit-exact
   against the oracle over all points, K2 once per instance, its wall) and
   one line comparing the plan's pinned upload of 2^20 packed scalars (32
   MiB) with a pageable one of the same bytes and with the per-call path's
   64 MiB of int32 words;
11. the command line (python -m msm_tpu_torch): verify --size 16 on the
   plain, compressed, GLV and GLV compressed configs, each bit-exact (the
   first in a process of its own, the others in this one with the counters
   reset just before and the path's kernels required just after); msm
   --size 16 against cpu --size 16; profile --size 20, its report printed;
12. the bench (python -m msm_tpu_torch.bench): --size 20 --verify on the
   four configs, --plan 4 --size 20 --verify, --batched 4 --size 16
   --verify and --auto --size 16 (its GLV compressed candidate's
   self-check at 2^14, then the faster verified candidate), every JSON
   line printed and verified (in this process, each checked for its
   path's kernels; step 18's bench processes start it as a user does);
13. the MSM above the one-pass cap: models.cuzk.CHUNK_MAX set to 2^20 and
   2^21 points run as two chunks (step 5's points twice, fresh scalars):
   run_gpu_msm on the four configs, the naive model, a plan (ints and
   words calls, run_batch of 2) and the batched model (2 instances), each
   bit-exact against the folded oracle, with its wall-clock and its
   point-add merge launches (the run's point adds less two passes', one
   per instance); then the constant restored;
14. one pass at 2^22 points on the plain, compressed, naive, GLV and GLV
   compressed configs, bit-exact, each with its peak device memory: the
   line that sets CHUNK_MAX, which must not exceed the largest power of two
   whose peak, scaled linearly, stays under 75% of the card's memory in
   every config; then a plain plan over 2^23 points as one pass (its build
   time; a words call on np.uint16 [2^23, 16] bit-exact, its median of 3
   and its peak memory);
15. the curves phase (PR 14): the plain path's six kernels (point add,
   convert, scan, row offsets, point total, Horner) are templates over the
   field, one instance a curve; each other curve's six instances against
   their twins at a small shape and at the shapes of its 2^16 MSM
   (BLS12-381's at its 2^20 MSM's: c 16, S 16, R 16384, C 64); each
   curve's MSM at 2^16 through run_gpu_msm and a plan's words call, and
   BLS12-381's at 2^20 through a plan's words call (median of 5), all
   bit-exact against the folded pure-Python
   oracle, BLS12-381's each with its stages, device busy time, idle share
   and peak
   memory, and the curve's kernels required of each run; verify --size 12
   on BLS12-381 and secp256k1 and the bench's --plan 4 --size 20 line on
   BLS12-381;
16. in the same phase (PR 15) the compressed, GLV and GLV compressed
   configs of the six curves: each instance against
   its twin at a small shape and at the shapes of the curve's 2^16 MSMs
   on those configs, where the
   kernel runs the whole launch and the twin of the scan, the Fermat
   inversion and the pair kernels 256 of its chains on the CPU (the first
   and last 64 lanes of its first and last subtask: chains share no state
   there), compared exactly; each curve on each config at
   2^16 through run_gpu_msm and a plan's words call (paths
   curve_<name>_<config>: a compressed run launches K9, K12 and K13, a GLV
   run only the *_glv modes), and BLS12-381's three configs at 2^20
   through a plan's words call (median of 5, stages, device busy time,
   idle share, peak memory), all bit-exact against the folded oracle;
17. in the same phase each other curve's forward products and
   backward emission (kernels 10 and 11) in both modes, its BPR phase 1
   and its scaled convert in five modes at the shapes of its 2^16
   compressed and GLV compressed MSMs (BLS12-381's at its 2^20 ones),
   twin over 256 chains on the CPU, BPR phase 1 at the blocked stage 4's
   2^16 shape (BLS12-381 also at 2^20), the scaled convert at 2^16,
   against their twins; then
   on each curve's 2^16 MSM compress_pairs without and with GLV against
   the oracle's pair sums, the scaled convert's five
   modes, the blocked stage 4 (window sums against the telescoped ones,
   the MSM bit-exact) and the naive model (8-bit windows, bit-exact), each
   a path of its own (counters reset just before); and validate=True
   through run_gpu_msm and a plan on BLS12-381 and BLS12-377 at 2^16
   (SUBGROUP_CHECKS): subgroup points pass bit-exact,
   the curve's smallest-x point outside the order-r subgroup, planted at
   n/3 + 1, raises ValueError at its index; each line with its seconds and
   point-add (K1) launches;
18. the sharded phase (parallel/, run_sharded_phase): two bench
   processes as two ranks of a gloo group and one as a one-rank NCCL group
   (``python -m msm_tpu_torch.bench --sharded R --multihost --verify`` at
   2^16, all on cuda:0, loopback only), started first and run beside the
   untimed checks, each rank's result equal and bit-exact, rank 0 alone
   printing the line; sharded_window_sums over 1, 2 and 4 shards of step
   5's 2^20 plain MSM on the card, counters reset just before, bit-exact
   against the folded oracle, the K1 tree checked alone (D - 1 additions
   a window in log2 D launches); plan_sharded over 2 shards at 2^20: an
   ints call, a words call and run_batch of 2, bit-exact; then, the bench
   processes ended: run_gpu_msm_sharded over 2 shards at 2^16 on the
   compressed and GLV configs and BLS12-381 plain, bit-exact; each shard
   count's wall median of 3 with each shard's host issue time and device
   span; the sharded plan's words call's median of 5 beside the
   single-device plan's, in turn;
19. the narrow library (widths 8 to 12): its build seconds, each unit's
   compile seconds and os.cpu_count(); the ptxas reports and SASS of every
   kernel instance of that library for the seven curves (no CALL; one
   instance serves every narrow width); then the width-12 phase
   (run_width_phase(12)): every instance against its twin at the small
   shapes, BN254's and BLS12-381's also at their 2^20 MSMs' shapes;
   each curve's 2^16 MSM at word_size 12 on the four configs (run_gpu_msm
   and a plan's words call), with compress_pairs, the scaled convert, the
   blocked stage 4 and the naive model, validate=True on BLS12-381,
   BN254's edge MSMs on five paths and a karatsuba=True MSM; BN254's 2^20
   plan words calls on the four configs and BLS12-381's plain one, all
   bit-exact against the folded oracle;
20. the narrow-widths phase (run_narrow_phase): run_width_phase at 8, 11,
   10 and 9 (the same checks and 2^16 MSMs on the four configs, the
   off-path instances against their twins only; at 8 BN254's and
   BLS12-381's instances also at their 2^20 MSMs' shapes, L 33 and 49); BN254's plain 2^20 words call at 8, 11
   and 13 in turn and BLS12-381's at 8, each with its peak memory; then
   the narrow library at width 13 against the default library, limb for
   limb, every wrapper of K1, K2 and K4 to K13 on the seven curves at the
   small shapes (check_libraries);
21. prints the kernels' JSON line (the GLV modes, the scaled convert,
   each other curve's instances and each narrow instance,
   ``name[curve,w8]`` to ``name[curve,w12]``, as entries of their own; each
   with its ptxas registers and spill bytes), then as its last line
   {"ok": true, "device": {...}}.

Any failure raises, and the script exits non-zero without the last line.
It needs a CUDA device and the repository around it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import os
import re
import signal
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

SEED = 2024
ROOT = Path(__file__).resolve().parent
REPLACES = {
    "point_add": ("csrc/point_add.cu", "msm_tpu/ops/pallas_curve.py:467"),
    "convert_pack": ("csrc/convert.cu", "msm_tpu/ops/pallas_convert.py:187"),
    "bucket_hist": ("csrc/hist.cu", "msm_tpu/ops/pallas_hist.py:83"),
    "scan_rows": ("csrc/scan.cu", "msm_tpu/ops/pallas_scan.py:374"),
    "row_offsets": ("csrc/prefix.cu", "msm_tpu/ops/pallas_prefix.py:133"),
    "point_total": ("csrc/point_total.cu", "msm_tpu/ops/pallas_prefix.py:231"),
    "horner": ("csrc/horner.cu", "msm_tpu/ops/pallas_prefix.py:335"),
    "mont_pow": ("csrc/inv.cu", "msm_tpu/ops/pallas_inv.py:92"),
    "pair_suffix": ("csrc/compress.cu", "msm_tpu/ops/pallas_compress.py:427"),
    "emit_scan": ("csrc/compress.cu", "msm_tpu/ops/pallas_compress.py:561"),
    "pair_forward": ("csrc/compress.cu", "msm_tpu/ops/pallas_compress.py:205"),
    "pair_backward": ("csrc/compress.cu", "msm_tpu/ops/pallas_compress.py:333"),
    "bpr_phase1": ("csrc/bpr.cu", "msm_tpu/ops/pallas_bpr.py:97"),
    "convert_pack_glv": ("csrc/convert.cu", "msm_tpu/ops/pallas_convert.py:187 (triple)"),
    "scan_rows_glv": ("csrc/scan.cu", "msm_tpu/ops/pallas_scan.py:374 (glv)"),
    "pair_suffix_glv": ("csrc/compress.cu", "msm_tpu/ops/pallas_compress.py:427 (glv)"),
    "emit_scan_glv": ("csrc/compress.cu", "msm_tpu/ops/pallas_compress.py:561 (glv)"),
    "pair_forward_glv": ("csrc/compress.cu", "msm_tpu/ops/pallas_compress.py:205 (glv)"),
    "pair_backward_glv": ("csrc/compress.cu", "msm_tpu/ops/pallas_compress.py:333 (glv)"),
    "convert_pack_scaled": ("csrc/convert.cu", "msm_tpu/ops/pallas_convert.py:187 (x_scale_int, dual)"),
}
#: the GLV modes, each a wrapper and counter of its own beside its kernel's
#: plain mode
GLV_MODES = ("convert_pack_glv", "scan_rows_glv", "pair_suffix_glv", "emit_scan_glv", "pair_forward_glv",
             "pair_backward_glv")
PLAIN_MODES = tuple(m.removesuffix("_glv") for m in GLV_MODES)
#: the kernels each path must launch; a kernel's count in the JSON line comes
#: from the first path that lists it
PATHS = {
    "plain": ("point_add", "convert_pack", "bucket_hist", "scan_rows", "row_offsets",
              "point_total", "horner"),
    "compressed": ("point_add", "convert_pack", "bucket_hist", "mont_pow", "pair_suffix",
                   "emit_scan", "row_offsets", "point_total", "horner"),
    "pairs": ("pair_forward", "mont_pow", "pair_backward"),
    "pairs_glv": ("pair_forward_glv", "mont_pow", "pair_backward_glv"),
    "naive": ("point_add", "convert_pack", "bucket_hist", "scan_rows", "row_offsets"),
    "blocked": ("point_add", "convert_pack", "bucket_hist", "scan_rows", "row_offsets",
                "point_total", "horner", "bpr_phase1"),
    "glv": ("point_add", "convert_pack_glv", "bucket_hist", "scan_rows_glv", "row_offsets",
            "point_total", "horner"),
    "glv_compressed": ("point_add", "convert_pack_glv", "bucket_hist", "mont_pow", "pair_suffix_glv",
                       "emit_scan_glv", "row_offsets", "point_total", "horner"),
    "convert_scaled": ("convert_pack_scaled",),
}
#: the kernels a path must not launch: a GLV path none of the plain modes,
#: the other paths none of the GLV modes, no MSM path the scaled convert, and
#: the pair-value and scaled-convert runs nothing but their own kernels
EXCLUDED = {
    "plain": GLV_MODES + ("convert_pack_scaled",),
    "compressed": ("scan_rows", "convert_pack_scaled") + GLV_MODES,
    "naive": ("point_total", "horner", "bpr_phase1", "convert_pack_scaled") + GLV_MODES,
    "blocked": GLV_MODES + ("convert_pack_scaled",),
    "glv": PLAIN_MODES + ("pair_suffix_glv", "emit_scan_glv", "mont_pow", "pair_forward_glv",
                          "pair_backward_glv", "convert_pack_scaled"),
    "glv_compressed": PLAIN_MODES + ("scan_rows_glv", "pair_forward_glv", "pair_backward_glv",
                                     "convert_pack_scaled"),
    **{path: tuple(k for k in REPLACES if k not in PATHS[path])
       for path in ("pairs", "pairs_glv", "convert_scaled")},
}
#: the serving plan's calls, a path of their own per config: the path's
#: kernels but the convert, which runs once, when the plan is built; the
#: batched model runs the plain path's, K2 once per instance
PLAN_PATHS = ("plain", "compressed", "glv", "glv_compressed")
CONVERTS = ("convert_pack", "convert_pack_glv")
PATHS.update({f"plan_{p}": tuple(k for k in PATHS[p] if k not in CONVERTS) for p in PLAN_PATHS})
PATHS["batched"] = PATHS["plain"]
EXCLUDED.update({f"plan_{p}": EXCLUDED[p] + CONVERTS for p in PLAN_PATHS})
EXCLUDED["batched"] = EXCLUDED["plain"]
#: the bench's --auto run: the plain config and the GLV compressed candidate
PATHS["auto"] = tuple(dict.fromkeys(PATHS["plain"] + PATHS["glv_compressed"]))
EXCLUDED["auto"] = tuple(k for k in REPLACES if k not in PATHS["auto"])
#: H100 SXM peaks: HBM bytes/s, and 32-bit IMAD per SM per clock (x 132 SMs
#: x the SM clock that nvidia-smi reports as clocks.max.sm)
HBM_BYTES_PER_S = 3.35e12
SMS, IMAD_PER_SM_CLOCK = 132, 64


def _imad_per_product(cfg) -> int:
    """IMAD of one Montgomery product's least work on the curve's D words
    (``params.coord_words``): 2 D^2 + D multiply-adds on 32-bit words, two
    IMAD each (low and high half; BN254: 2 * 136)."""
    from msm_tpu_torch.params import coord_words

    d = coord_words(cfg)
    return 2 * (2 * d * d + d)


def _square_per_product(cfg) -> float:
    """A squaring's least work in products on the curve's D words: D (D + 1)
    / 2 word products for a^2 and the D^2 + D of the reduction, over a
    product's 2 D^2 + D (BN254: 108 of 136)."""
    from msm_tpu_torch.params import coord_words

    d = coord_words(cfg)
    return (d * (d + 1) // 2 + d * d + d) / (2 * d * d + d)


def _fe_bytes(cfg) -> int:
    """Bytes of one field element of the curve, the least a coordinate
    needs: 4 D (BN254: 32; BLS12: 48)."""
    from msm_tpu_torch.params import coord_words

    return 4 * coord_words(cfg)


def _kernels():
    from msm_tpu_torch.ops import (cuda_bpr, cuda_compress, cuda_convert, cuda_curve, cuda_hist,
                                   cuda_inv, cuda_prefix, cuda_scan)

    return {
        "point_add": (cuda_curve.point_add, cuda_curve.point_add_plain),
        "convert_pack": (cuda_convert.convert_pack, cuda_convert.convert_pack_plain),
        "bucket_hist": (cuda_hist.bucket_hist, lambda cfg, keys, nb: cuda_hist.bucket_hist_plain(keys, nb)),
        "scan_rows": (cuda_scan.scan_rows, cuda_scan.scan_rows_plain),
        "row_offsets": (cuda_prefix.row_offsets, cuda_prefix.row_offsets_plain),
        "point_total": (cuda_prefix.point_total, cuda_prefix.point_total_plain),
        "horner": (cuda_prefix.horner, cuda_prefix.horner_plain),
        "mont_pow": (cuda_inv.mont_pow, cuda_inv.mont_pow_plain),
        "pair_suffix": (cuda_compress.pair_suffix, cuda_compress.pair_suffix_plain),
        "emit_scan": (cuda_compress.emit_scan, cuda_compress.emit_scan_plain),
        "pair_forward": (cuda_compress.pair_forward, cuda_compress.pair_forward_plain),
        "pair_backward": (cuda_compress.pair_backward, cuda_compress.pair_backward_plain),
        "bpr_phase1": (cuda_bpr.bpr_phase1, cuda_bpr.bpr_phase1_plain),
        "convert_pack_glv": (cuda_convert.convert_pack_glv, cuda_convert.convert_pack_plain),
        "scan_rows_glv": (cuda_scan.scan_rows_glv, cuda_scan.scan_rows_plain),
        "pair_suffix_glv": (cuda_compress.pair_suffix_glv, cuda_compress.pair_suffix_plain),
        "emit_scan_glv": (cuda_compress.emit_scan_glv, cuda_compress.emit_scan_plain),
        "pair_forward_glv": (cuda_compress.pair_forward_glv, cuda_compress.pair_forward_plain),
        "pair_backward_glv": (cuda_compress.pair_backward_glv, cuda_compress.pair_backward_plain),
        "convert_pack_scaled": (cuda_convert.convert_pack_scaled, cuda_convert.convert_pack_scaled_plain),
    }


#: the kernels one launch of a wrapper runs, by their names in a profiler
#: trace, for the wrappers that run more than one (csrc/prefix.cu,
#: csrc/point_total.cu); every other wrapper runs one kernel per launch
TRACE_KERNELS = {"row_offsets": ("k_ro_totals", "k_ro_blocks", "k_ro_write"),
                 "point_total": ("k_point_total", "k_point_total_finish")}
#: a trace kernel's name -> its wrapper's row in the device breakdown
TRACE_ROWS = {k: f"k_{name}" for name, ks in TRACE_KERNELS.items() for k in ks}


def _reset_counts() -> None:
    for wrapper, _plain in _kernels().values():
        wrapper.launches = 0


def _timed(fn):
    """(result, ms) of one call, by CUDA events around it: the plain twins'
    cost, host launch overhead included."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


#: device clock cycles of the spin kernel that holds the device while the
#: host enqueues the timed calls (~10 ms at 1980 MHz; _kernel_ms
#: lengthens it where the enqueueing outlasts it)
SPIN_CYCLES = 20_000_000


def _kernel_ms(fn, reps: int):
    """(result, ms per call) of the device work a wrapper enqueues: CUDA
    events around ``reps`` calls that the host enqueues while a spin kernel
    holds the device, so the calls run back to back and the wrappers' host
    overhead (larger than the shortest kernels) stays out of the time. One
    warm-up call first. When the spin has ended before the last call was
    enqueued (the start event already passed), the round is timed again
    behind a spin 8 and then 64 times as long."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for cycles in (SPIN_CYCLES, 8 * SPIN_CYCLES, 64 * SPIN_CYCLES):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        held = not start.query()
        torch.cuda.synchronize()
        if held:
            break
    return out, start.elapsed_time(end) / reps


def _mont(vals, cfg):
    """python ints -> Montgomery-form canonical limbs [n, L] int32."""
    from msm_tpu_torch.utils.limbs import ints_to_limbs

    p = cfg.curve.modulus
    return ints_to_limbs([v * cfg.r % p for v in vals], cfg.word_size, cfg.num_words).astype(np.int32)


def _rand_fe(rng, shape, cfg):
    """Random canonical field elements as int32 limbs [..., L]: the
    modulus' highest nonzero limb k drawn below its value, the limbs above
    it 0 (BLS12-377's top limb), so every value is < p."""
    L, w = cfg.num_words, cfg.word_size
    k = (cfg.curve.modulus_bits - 1) // w
    a = rng.integers(0, 1 << w, size=tuple(shape) + (L,), dtype=np.int64)
    a[..., k] = rng.integers(0, cfg.curve.modulus >> (w * k), size=shape)
    a[..., k + 1:] = 0
    return a.astype(np.int32)


def _curve_points(rng, shape, cfg, base, device):
    """Real curve points in random projective form (x*z : y*z : z), drawn
    from the Montgomery affine ``base`` rows [2, m, L]; index 0 of the last
    batch axis is the identity. Sums in different orders agree only for
    points on the curve, so the reassociating kernels get these."""
    from msm_tpu_torch.ops.field import get_field_ctx

    f = get_field_ctx(cfg)
    idx = torch.from_numpy(rng.integers(0, base.shape[1], size=shape)).to(device)
    z = torch.from_numpy(_rand_fe(rng, shape, cfg)).to(device)
    z[..., 0, :] = 0
    x, y = (f.canonical(f.mont_mul(base[i][idx], z)) for i in range(2))
    y[..., 0, :] = f.const(f.r_limbs, device)
    return x, y, z


def _pair_stream(rng, G, C, R, rows):
    """perm, flags [G, C, R] over a table of ``rows`` points, with doubling
    pairs (same row, same sign) and infinity pairs (same row, opposite sign)
    planted at pair positions (2j, 2j+1)."""
    perm = rng.integers(0, rows, size=(G, C, R)).astype(np.int32)
    flags = rng.integers(0, 2, size=(G, C, R)).astype(np.int32)
    kind = rng.random((G, C // 2, R))
    for planted, flip in ((kind < 0.2, 0), (kind > 0.85, 1)):
        g, j, r = np.nonzero(planted)
        perm[g, 2 * j + 1, r] = perm[g, 2 * j, r]
        flags[g, 2 * j + 1, r] = flags[g, 2 * j, r] ^ flip
    return perm, flags


def _bpr_buckets(rng, shape, cfg):
    """Kernel 8's buckets [G, Bl, T, L] x3: random canonical field triples
    with planted rows, drawing nothing more from rng: y negated (balanced
    limbs) on every fourth chain, the identity at the second step of chains
    3 mod 8 (acc + m there adds a point to itself), and the first bucket
    again at the second step of chains 5 mod 8 (m + B there adds a point to
    itself). The kernel adds in its twin's order, so these need not be
    curve points."""
    b = [_rand_fe(rng, shape, cfg) for _ in range(3)]
    Bl = shape[1]
    b[1][:, :, ::4] *= -1
    for c, v in zip(b, (0, _mont([1], cfg)[0], 0)):
        c[:, max(Bl - 2, 0), 3::8] = v
    if Bl > 1:
        for c in b:
            c[:, Bl - 2, 5::8] = c[:, Bl - 1, 5::8]
    return b


def _field_outputs(name, out, L):
    """A kernel's outputs as (limbs-last field tensors, plain integer
    tensors) for the comparison (a GLV mode's as its kernel's)."""
    name = name.removesuffix("_glv")
    if name in ("bucket_hist", "convert_pack", "convert_pack_scaled"):  # the dual mode: two tables
        return [], list(out) if isinstance(out, tuple) else [out]
    if name in ("scan_rows", "emit_scan"):  # pe3 rows by coordinate; totals limbs-first
        return [out[0][..., i * L:(i + 1) * L] for i in range(3)] + [a.transpose(1, 2) for a in out[1:]], []
    if name in ("mont_pow", "pair_suffix", "pair_forward"):
        return [out.transpose(-1, -2)], []
    if name == "pair_backward":
        return [a.transpose(-1, -2) for a in out[:2]], [out[2]]
    return list(out), []


def _compare(f, got, want, as_points: bool) -> int:
    """Max abs difference of canonical limbs: of the coordinates themselves,
    or, for points, of the cross products X1 Z2 - X2 Z1 and Y1 Z2 - Y2 Z1."""
    if as_points:
        (x1, y1, z1), (x2, y2, z2) = got, want
        got = (f.mont_mul(x1, z2), f.mont_mul(y1, z2))
        want = (f.mont_mul(x2, z1), f.mont_mul(y2, z1))
    err = 0
    for g, w in zip(got, want):
        d = f.canonical(g).to(torch.int64) - f.canonical(w).to(torch.int64)
        err = max(err, int(d.abs().max()))
    return err


def _products(name, args) -> float:
    """Montgomery products the kernel's function needs on these inputs,
    counted from the formulas in csrc: complete addition 12, mixed addition
    11, doubling 8 (the multiplication by 3b is free), to-Montgomery 1 per
    coordinate, Fermat inversion the shorter of the binary chain and the
    4-bit window's (_pow_chains), a squaring at _square_per_product; per pair,
    suffix and forward products 1, backward emission 5, emission 5 plus the
    mixed addition's 11, and one more for a doubling; an infinity pair
    needs none of these (its d is one and its sum is not read), nor does
    an addition with the identity (_bpr_additions). A GLV mode
    counts as its kernel, the convert with one more product a point
    (beta x), as does the scaled convert with a second x constant."""
    shape = args[1].shape
    if name == "convert_pack_glv" or (name == "convert_pack_scaled" and args[4] is not None):
        return 3 * shape[0]
    if name == "convert_pack_scaled":
        return 2 * shape[0]
    name = name.removesuffix("_glv")
    if name == "point_add":
        return 12 * shape[0]
    if name == "convert_pack":
        return 2 * shape[0]
    if name == "bucket_hist":
        return 0
    if name == "scan_rows":
        return 11 * args[2].numel()
    if name == "row_offsets":  # lane totals [G, L, R]
        return 12 * shape[0] * (shape[2] - 1)
    if name == "point_total":  # [S, N, L]
        return 12 * shape[0] * (shape[1] - 1)
    if name == "horner":  # [S, L] or G ladders [G, S, L]
        return (args[1].numel() // (shape[-2] * shape[-1])) * (shape[-2] - 1) * (8 * args[4] + 12)
    if name == "mont_pow":
        return shape[0] * shape[2] * min(
            mul + _square_per_product(args[0]) * sqr for sqr, mul in _pow_chains(args[2]))
    if name == "bpr_phase1":
        return 12 * _bpr_additions(args)
    pairs = args[2].numel() // 2
    dbl, inf = _pair_kinds(args)
    if name == "emit_scan":
        return 16 * (pairs - inf) + dbl
    if name == "pair_backward":
        return 5 * (pairs - inf) + dbl
    return pairs - inf  # pair_suffix, pair_forward



def _pow_chains(e: int) -> list[tuple[int, int]]:
    """(squarings, other products) of a^e by square-and-multiply (one
    squaring a bit, a product a set bit) and by the fixed 4-bit window the
    Fermat kernel runs (csrc/pow32.cuh: a table of a^1 .. a^15, one squaring
    and 13 products; four squarings a digit below the top one, a product a
    digit that is not 0)."""
    nd = (e.bit_length() + 3) // 4
    lower = [(e >> (4 * i)) & 15 for i in range(nd - 1)]
    window = (1 + 4 * (nd - 1), 13 + sum(1 for d in lower if d)) if nd else (0, 0)
    binary = (max(e.bit_length() - 1, 0), max(bin(e).count("1") - 1, 0))  # from a, not from one
    return [binary, window]


def _pair_kinds(args) -> tuple[int, int]:
    """(doubling pairs, infinity pairs) of a pair kernel's stream (cfg,
    packed table, perm, flags [G, C, R]), by the twins' predicates."""
    from msm_tpu_torch.ops.cuda_compress import pair_predicates_plain
    from msm_tpu_torch.ops.cuda_convert import unpack_coords
    from msm_tpu_torch.ops.cuda_scan import element_coords

    cfg, table, perm, flags = args[:4]
    dbl = inf = 0
    for g in range(perm.shape[0]):  # a subtask at a time: bounded memory
        rows = table[perm[g].long()]  # [C, R, 2D or 3D]
        x, y = (unpack_coords(a, cfg) for a in element_coords(cfg, rows, flags[g]))
        sg = flags[g] & 1
        d, i = pair_predicates_plain(cfg, x[0::2], y[0::2], sg[0::2], x[1::2], y[1::2], sg[1::2])
        dbl, inf = dbl + int(d.sum()), inf + int(i.sum())
    return dbl, inf


def _bpr_additions(args) -> int:
    """Additions kernel 8's function needs on buckets (cfg, bx, by, bz)
    [G, Bl, T, L]: per chain and step, from the top down, m + B unless m
    or B is the identity (z = 0), and acc + m unless acc is the identity,
    i.e. unless every bucket above this step is (m is then the identity
    too, or this step's m is B). With no identity bucket that is
    2 (Bl - 1) a chain: the first m and acc additions start from the
    identity."""
    from msm_tpu_torch.ops.field import get_field_ctx

    empty = (get_field_ctx(args[0]).canonical(args[3]) == 0).all(-1).flip(1)  # [G, Bl, T], top first
    m_empty = empty.to(torch.int32).cumprod(1).bool()  # m after each step is the identity
    before = torch.cat([torch.ones_like(m_empty[:, :1]), m_empty[:, :-1]], 1)  # m before each step
    return int((~(before | empty)).sum()) + int((~before).sum())


def _horner_depth(args) -> int:
    """Products on a Horner ladder's dependent chain: two per doubling and
    per addition, the lanes of a warp splitting each formula's products
    (csrc/horner.cu); G ladders run side by side."""
    S, chunk = args[1].shape[-2], args[4]
    return (S - 1) * (2 * chunk + 2)


def _int_bytes(hi: int) -> int:
    """Bytes of the narrowest integer type that holds 0 .. hi."""
    return 1 if hi < 1 << 8 else 2 if hi < 1 << 16 else 4


def _least_bytes(name, args) -> float:
    """Bytes the kernel's function must move on these inputs, each input
    read once and each output written once: 32 B per 254-bit field element
    (96 B per projective point, 64 B per packed affine row, 96 B per GLV
    row), 2 B per u16 word, the narrowest integer type per key, count or
    table index, 1 bit per flag (2 under GLV: the sign and the phi bit).
    The limb layout's padding (80 B per coordinate at 13-bit limbs, 4 B per
    u16 word) is the kernels' choice, not the function's. On another curve
    an element is 4 D bytes (_fe_bytes; BLS12: 48) and a coordinate 2 D u16
    words."""
    a = args[1:]
    fe = _fe_bytes(args[0])
    u16 = _fe_bytes(args[0]) // 2
    glv = name.endswith("_glv")
    name = name.removesuffix("_glv")
    if name == "point_add":  # six [B, L] in, three out
        return 9 * fe * a[0].shape[0]
    if name == "convert_pack":  # [n, 2D] u16 words x2 -> [n, 2D] (GLV: [n, 3D])
        return a[0].shape[0] * (2 * u16 * 2 + (3 if glv else 2) * fe)
    if name == "convert_pack_scaled":  # (x_scale, dual_x_scale, triple) -> [n, 2D], two or [n, 3D]
        coords = 2 if args[4] is None else 3 if args[5] else 4
        return a[0].shape[0] * (2 * u16 * 2 + coords * fe)
    if name == "bucket_hist":  # keys [G, n] < NB -> counts [G, NB] <= n
        keys, nb = a[0], a[1]
        return keys.numel() * _int_bytes(nb - 1) + keys.shape[0] * nb * _int_bytes(keys.shape[1])
    if name in ("row_offsets", "mont_pow"):  # [G, L, R] lanes, in and out
        lanes = a[0].shape[0] * a[0].shape[2]
        return 2 * lanes * (3 if name == "row_offsets" else 1) * fe
    if name in ("point_total", "horner"):  # [G, N, L], [G, S, L] or [S, L] -> one point per G
        pts = a[0].numel() // a[0].shape[-1]
        return 3 * fe * (pts + pts // a[0].shape[-2])
    if name == "bpr_phase1":  # [G, Bl, T, L] buckets -> m, g [G, T, L]
        G, Bl, T, _ = a[0].shape
        return 3 * fe * G * T * (Bl + 2)
    # the scan and the pair kernels: a packed table, perm and flags [G, C, R]
    table, perm = a[0], a[1]
    rows, steps, lanes = table.shape[0], perm.numel(), perm.shape[0] * perm.shape[2]
    coords = 3 if glv else 2
    stream = rows * coords * fe + steps * (_int_bytes(rows - 1) + (coords - 1) / 8)
    if name == "scan_rows":  # -> pe3 per step, lane totals
        return stream + 3 * fe * (steps + lanes)
    pairs = steps // 2
    if name in ("pair_suffix", "pair_forward"):  # -> one product per pair
        return stream + pairs * fe
    chain_in = (pairs + lanes) * fe  # products per pair, inverse per lane
    if name == "emit_scan":  # -> pe3 per pair, lane totals
        return stream + chain_in + 3 * fe * (pairs + lanes)
    return stream + chain_in + pairs * (2 * fe + 1 / 8)  # pair_backward: x, y, inf


def _bound(name, args, clock_hz) -> tuple[float, str]:
    """(least ms, "bytes" or "operations"): the larger of the products'
    IMAD over the card's integer rate and the least bytes over the HBM
    rate."""
    ops_s = _products(name, args) * _imad_per_product(args[0]) / (SMS * IMAD_PER_SM_CLOCK * clock_hz)
    bytes_s = _least_bytes(name, args) / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


#: the kernels whose launch is a grid of independent chains, one thread a
#: (subtask g, lane r), sharing no state: the scan, the Fermat inversion,
#: the four pair kernels and BPR phase 1 (check_case's ``subset``).
#: By argument position, the lane axis of each argument that indexes the
#: chains (their subtask axis is 0), and the lane axis of every output (or
#: of each output)
CHAIN_ARGS = {"scan_rows": {2: 2, 3: 2}, "mont_pow": {1: 2}, "pair_suffix": {2: 2, 3: 2},
              "emit_scan": {2: 2, 3: 2, 4: 3, 5: 2}, "pair_forward": {2: 2, 3: 2},
              "pair_backward": {2: 2, 3: 2, 4: 3, 5: 2}, "bpr_phase1": {1: 2, 2: 2, 3: 2}}
CHAIN_OUT_LANE = {"scan_rows": 2, "mont_pow": 2, "pair_suffix": 3, "emit_scan": 2, "pair_forward": 3,
                  "pair_backward": (3, 3, 2), "bpr_phase1": 1}


def _chains(name, args, out, subset):
    """The twin's arguments on the chains ``subset`` = (subtasks, lanes) of
    the launch, and the kernel's outputs on those chains."""
    base = name.removesuffix("_glv")
    g, r = (torch.tensor(i, device=args[1].device) for i in subset)

    def cut(t, lane_axis):
        return t.index_select(0, g).index_select(lane_axis, r)

    args = [cut(a, CHAIN_ARGS[base][i]) if i in CHAIN_ARGS[base] else a for i, a in enumerate(args)]
    axis = CHAIN_OUT_LANE[base]
    if not isinstance(out, tuple):
        return args, cut(out, axis)
    axes = axis if isinstance(axis, tuple) else (axis,) * len(out)
    return args, tuple(cut(o, a) for o, a in zip(out, axes))


def chain_subset(name, args, lanes: int = 64):
    """(subtasks, lanes) of a launch's chains for check_case's ``subset``:
    its first and last subtask, and in each the first and last ``lanes``
    lanes."""
    base = name.removesuffix("_glv")
    pos, axis = next(iter(CHAIN_ARGS[base].items()))
    G, R = args[pos].shape[0], args[pos].shape[axis]
    return [0, G - 1], list(range(lanes)) + list(range(R - lanes, R))


#: a twin whose tensor inputs hold at most this many elements runs on the
#: host's CPU, where a small op costs less than a launch on the card (the
#: Horner ladder's serial chain over [S, L]: ~5x faster; the small shapes)
CPU_TWIN_ELEMS = 1 << 18
#: a chain kernel's twin over more inputs than that, whose chains walk at
#: least this many serial steps (_serial_steps), runs on chain_subset's 256
#: chains on the CPU: its cost is its steps' op overhead, not its lanes
#: (BN254's emission + scan under GLV at 2^20, 1024 steps: 52 s on the
#: card for the whole launch)
SUBSET_STEPS = 128


def _serial_steps(name, args) -> int:
    """Serial steps of a chain kernel's chains, in its twin's launches: the
    exponent's bits (the Fermat kernel), BPR phase 1's 2 Bl point
    additions of 12 products each, else the stream's steps (perm [G, C,
    R])."""
    if name == "mont_pow":
        return args[2].bit_length()
    if name == "bpr_phase1":
        return 2 * args[1].shape[1] * 12
    return args[2].shape[1]


def _to(dev, out):
    """A twin's output (a tensor or a tuple of them) on ``dev``."""
    return tuple(o.to(dev) for o in out) if isinstance(out, tuple) else out.to(dev)


#: worker processes for the twins that run on the CPU: the host's cores but
#: two. A twin's time is its serial steps' op overhead on one core, so
#: several run side by side while the main process times the kernels
TWIN_WORKERS = max(1, (os.cpu_count() or 2) - 2)
_TWIN_POOL = None
#: the comparisons of the checks whose twins are still in the workers, in
#: the order the checks were made (settle runs them)
_UNSETTLED: list = []


def _twin_worker_init() -> None:
    torch.set_num_threads(1)


def _run_twin(name, args):
    """(output, ms) of a kernel's twin on CPU tensors, in a worker process."""
    plain = _kernels()[name][1]
    t0 = time.perf_counter()
    out = plain(*args)
    return out, (time.perf_counter() - t0) * 1e3


def _twin_pool():
    global _TWIN_POOL
    if _TWIN_POOL is None:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        _TWIN_POOL = ProcessPoolExecutor(TWIN_WORKERS, mp_context=multiprocessing.get_context("spawn"),
                                         initializer=_twin_worker_init)
    return _TWIN_POOL


def settle() -> None:
    """Wait for the twins in the workers and compare each with its kernel's
    output, in the order the checks were made: each check's line printed
    and its result dict filled (a difference raises). Every group of
    checks (BN254's kernels; one curve's instances at 13 bits; every
    curve's at one narrow width) ends with it, so no kernel output
    outlives its group."""
    while _UNSETTLED:
        _UNSETTLED.pop(0)()


def _check_case(kern, f, L, name, label, args, as_points, reps, clock_hz, subset=None) -> dict:
    """One kernel against its twin on the same inputs: exact after
    canonicalization (as points: by cross-multiplication); raises on any
    difference. With ``subset`` (subtasks, lanes: chain_subset; by default
    for a chain kernel of SUBSET_STEPS steps or more over more than
    CPU_TWIN_ELEMS inputs) the kernel runs the whole launch and its twin
    only those chains (CHAIN_ARGS: the chains share no state in these
    kernels), on the CPU, and the kernel's outputs there are compared;
    plain_ms is then the twin's time on them.
    A twin of at most CPU_TWIN_ELEMS input elements runs on copies of its
    inputs on the CPU too (plain_ms then the CPU's time; the label says
    "twin on the CPU"). A twin on the CPU runs in a worker process
    (_twin_pool) and its comparison waits for settle(); the returned dict
    is filled then. Returns {max_abs_err, ms, plain_ms, bound_ms,
    bound_by}."""
    wrapper, plain = kern[name]
    if _LIB_CHECK is not None:
        return _compare_libraries(wrapper, name, label, args, L)
    got, ms = _kernel_ms(lambda: wrapper(*args), reps)
    if (subset is None and name.removesuffix("_glv") in CHAIN_ARGS and _serial_steps(name, args) >= SUBSET_STEPS
            and sum(a.numel() for a in args if isinstance(a, torch.Tensor)) > CPU_TWIN_ELEMS):
        subset = chain_subset(name, args)
    twin_args = args
    if subset is not None:
        twin_args, got = _chains(name, args, got, subset)
        (g0, g1), r = subset[0], subset[1]
        label = (f"{label} (twin on subtasks {g0},{g1} x lanes {r[0]}-{r[len(r) // 2 - 1]},"
                 f"{r[len(r) // 2]}-{r[-1]})")
    dev = args[1].device
    on_cpu = subset is not None or sum(a.numel() for a in twin_args if isinstance(a, torch.Tensor)) <= CPU_TWIN_ELEMS
    if on_cpu:
        twin_args = [a.cpu() if isinstance(a, torch.Tensor) else a for a in twin_args]
        label = f"{label} (twin on the CPU)"
    bound_ms, bound_by = _bound(name, args, clock_hz)
    # the Horner ladder is one dependent chain: its depth in products is
    # the floor that matters there
    depth = ""
    if name == "horner":
        depth = f" products={_products(name, args)} chain_depth={_horner_depth(args)}"
    result = {}

    def finish(want, plain_ms):
        want = _to(dev, want)
        (gf, gi), (wf, wi) = _field_outputs(name, got, L), _field_outputs(name, want, L)
        err = max([_compare(f, gf, wf, as_points) if gf else 0]
                  + [int((a.long() - b.long()).abs().max()) for a, b in zip(gi, wi)])
        print(f"check {name:13s} {label:5s} max_abs_err={err} kernel_ms={ms:.4f} plain_ms={plain_ms:.2f}"
              f" bound_ms={bound_ms:.4f} ({bound_by}){depth}", flush=True)
        if err != 0:
            raise AssertionError(f"{name} ({label}) disagrees with its twin: max_abs_err={err}")
        result.update({"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by})

    if on_cpu:
        twin = _twin_pool().submit(_run_twin, name, twin_args)
        _UNSETTLED.append(lambda: finish(*twin.result()))
    else:
        finish(*_timed(lambda: plain(*twin_args)))
    return result


def check_kernels(clock_hz: float, sizes=("small", "slice"), device="cuda") -> dict:
    """Every kernel against its twin on the card; returns per-kernel
    {max_abs_err, ms, plain_ms, bound_ms, bound_by, library_ms} from the
    slice shape (or the last size)."""
    from msm_tpu_torch.oracle.pyecc import Curve
    from msm_tpu_torch.params import BN254, MsmConfig, pick_config
    from msm_tpu_torch.ops.cuda_convert import pack_canonical
    from msm_tpu_torch.ops.field import get_field_ctx

    dev = torch.device(device)
    rng = np.random.default_rng(SEED)
    kern = _kernels()
    out = {}
    base_cfg = MsmConfig(curve=BN254)
    aff = [Curve(BN254).to_affine(p) for p in Curve(BN254).sample_points(256, seed=SEED)]
    base = torch.stack([torch.from_numpy(_mont(v, base_cfg)) for v in zip(*aff)]).to(dev)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    table = torch.cat([pack_canonical(base[i], base_cfg) for i in range(2)], dim=-1)
    # first: their 2^20 chain twins, the longest, overlap the checks below
    out.update(check_glv_kernels(kern, aff, clock_hz, sizes, dev))
    for size in sizes:
        small = size == "small"
        cfg = MsmConfig(curve=BN254, chunk_size=8) if small else pick_config(1 << 20)
        f = get_field_ctx(cfg)
        L = cfg.num_words
        # the 2^20 MSM's shapes: c = 16, S = 16, R = 16384, C = 64, batch 4
        n = 2048 if small else 1 << 20
        R = 512 if small else 1 << 14
        C = 4 if small else n // R
        G = 1 if small else 4
        NB = cfg.num_buckets
        S = 4 if small else cfg.num_subtasks
        cases = {}
        # point add: batch of the prefix_at call; some inputs balanced (-y)
        B = 512 if small else G * NB
        pa = [_rand_fe(rng, (B,), cfg) for _ in range(6)]
        pa[1][: B // 8] *= -1
        cases["point_add"] = ([cfg, *map(t, pa)], False, 5)
        # convert: u16 words (held in int16) of random coordinates below p
        cases["convert_pack"] = ([cfg, *map(t, _coord_words(rng, n, cfg.curve.modulus))], False, 5)
        # histogram: every subtask's keys at once
        keys = rng.integers(0, NB, size=(S if not small else 2, n), dtype=np.int32)
        cases["bucket_hist"] = ([cfg, t(keys), NB], False, 5)
        # scan: a random canonical table, a random permutation, random signs
        tab = torch.cat([pack_canonical(torch.from_numpy(_rand_fe(rng, (n,), cfg)), cfg)
                         for _ in range(2)], dim=-1)
        perm = np.stack([rng.permutation(n).reshape(R, C).T for _ in range(G)]).astype(np.int32)
        flags = rng.integers(0, 2, size=perm.shape, dtype=np.int32)
        cases["scan_rows"] = ([cfg, tab.to(dev), t(perm), t(flags)], False, 3)
        rows = _curve_points(rng, (G, R), cfg, base, dev)
        cases["row_offsets"] = ([cfg, *(a.transpose(1, 2).contiguous() for a in rows)], True, 3)
        N = 512 if small else NB - 1
        cases["point_total"] = ([cfg, *_curve_points(rng, (S, N), cfg, base, dev)], True, 3)
        cases["horner"] = ([cfg, *(t(_rand_fe(rng, (S,), cfg)) for _ in range(3)),
                            4 if small else cfg.chunk_size], False, 3)
        # pair kernels at the compressed 2^20 MSM's shapes (the geometry
        # rule's R lanes, C = n / R steps, its subtasks per launch) over 256
        # real points; the chain inputs are the kernels' own (canonical)
        # outputs. compress_pairs (kernels 10, 11) keeps the TPU rule's
        # R = 1024, C = 1024, 4 subtasks.
        G2, C2, R2 = (1, 8, 64) if small else _compressed_shape(1 << 20)
        lanes = _rand_fe(rng, (G2, R2), cfg)
        lanes[0, :2] = _mont([1, cfg.curve.modulus - 1], cfg)
        cases["mont_pow"] = ([cfg, t(lanes).transpose(1, 2).contiguous(), cfg.curve.modulus - 2], False, 3)
        pair_in = [cfg, table, *map(t, _pair_stream(rng, G2, C2, R2, table.shape[0]))]
        cases["pair_suffix"] = (pair_in, False, 3)
        cases["emit_scan"] = (_emit_scan_args(kern, pair_in), False, 3)
        pair_in = [cfg, table, *map(t, _pair_stream(rng, *((1, 8, 64) if small else (4, 1024, 1024)),
                                                    table.shape[0]))]
        cases["pair_forward"] = (pair_in, False, 3)
        cases["pair_backward"] = (_backward_args(kern, pair_in), False, 3)
        # blocked reduction, phase 1: the 2^20 MSM's 16 windows of 32768
        # body buckets at bpr_threads = 512 lanes (Bl = 64)
        G3, T3, Bl3 = (1, 16, 16) if small else (cfg.num_subtasks, 512, (NB - 1) // 512)
        cases["bpr_phase1"] = ([cfg, *map(t, _bpr_buckets(rng, (G3, Bl3, T3), cfg))], False, 3)
        for name, (args, as_points, reps) in cases.items():
            out[name] = _check_case(kern, f, L, name, size, args, as_points, reps, clock_hz)
            out[name]["library_ms"] = None
        # the one PyTorch call that computes a kernel's function: the
        # histogram as torch.bincount over keys offset by subtask
        lib_ms = _bincount_ms(cases["bucket_hist"][0][1], NB)
        out["bucket_hist"]["library_ms"] = lib_ms
        print(f"library bucket_hist {size:5s} torch.bincount ms={lib_ms:.4f}", flush=True)
        if not small:
            scan_after(kern, cases)
    if "slice" in sizes:
        check_path_shapes(kern, rng, base, dev, clock_hz)
        check_redesigned_shapes(kern, rng, base, dev, clock_hz)
        check_convert_emit_shapes(kern, rng, table, dev, clock_hz)
        check_suffix_pow_shapes(kern, rng, table, dev, clock_hz)
        check_pair_value_shapes(kern, rng, table, dev, clock_hz)
        check_bpr_shapes(kern, rng, dev, clock_hz)
    out.update(check_convert_scaled(kern, clock_hz, sizes, dev))
    settle()
    return out


def check_glv_kernels(kern, aff, clock_hz: float, sizes, dev) -> dict:
    """The six GLV modes against their twins, before the other checks of
    check_kernels and on a random stream of their own (so those draw the
    same inputs as before GLV came): at a small shape and at the GLV 2^20 MSM's
    shapes (c = 16, S = 8, every subtask 2^21 entries; the scan G4 C128
    R16384, the pair modes the compressed rule's G8 C1024 R2048 over a
    table of 128 points and their phi images: the four pair kernels on one
    stream), then at the GLV 2^16 shapes (check_glv_shapes). Returns
    per-mode results from the 2^20 shapes."""
    from msm_tpu_torch.ops.field import get_field_ctx
    from msm_tpu_torch.params import BN254, MsmConfig, pick_config

    rng = np.random.default_rng(SEED + 9)
    glv_table = _glv_table(aff[:128], MsmConfig(curve=BN254)).to(dev)
    out = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    for size in sizes:
        small = size == "small"
        cfg = MsmConfig(curve=BN254, chunk_size=8, glv=True) if small else \
            dataclasses.replace(pick_config(1 << 20), glv=True)
        f, L = get_field_ctx(cfg), cfg.num_words
        n, G, R = (2048, 1, 512) if small else (1 << 20, 4, 1 << 14)
        G4, C4, R4 = (1, 8, 64) if small else _compressed_shape(1 << 20, dataclasses.replace(cfg, compress=True))
        pair_in = [cfg, glv_table, *map(t, _glv_pair_stream(rng, G4, C4, R4, glv_table.shape[0]))]
        cases = {
            "convert_pack_glv": ([cfg, *map(t, _coord_words(rng, n, cfg.curve.modulus))], 5),
            "scan_rows_glv": ([cfg, *_glv_scan_inputs(rng, n, G, R, cfg, dev)], 3),
            "pair_suffix_glv": (pair_in, 3),
            "emit_scan_glv": (_emit_scan_args(kern, pair_in), 3),
            "pair_forward_glv": (pair_in, 3),
            "pair_backward_glv": (_backward_args(kern, pair_in), 3),
        }
        for name, (args, reps) in cases.items():
            out[name] = _check_case(kern, f, L, name, size, args, False, reps, clock_hz)
            out[name]["library_ms"] = None
    if "slice" in sizes:
        check_glv_shapes(kern, rng, glv_table, dev, clock_hz)
    return out


def _coord_words(rng, n: int, top: int | None, wu: int = 16):
    """x and y u16 coordinate words [n, wu] (BN254: 16), held in int16 as
    the host serializes them: values below p when ``top`` is the modulus
    (top word below its top word), else anywhere in [0, 2^(16 wu))."""
    words = rng.integers(0, 1 << 16, size=(2, n, wu), dtype=np.int64)
    if top is not None:
        words[:, :, wu - 1] = rng.integers(0, top >> (16 * (wu - 1)), size=(2, n))
    return [np.ascontiguousarray(w.astype(np.uint16).view(np.int16)) for w in words]


def _compressed_shape(n: int, cfg=None) -> tuple[int, int, int]:
    """(G, C, R) of the compressed MSM's scan launches at n points:
    models/geometry.py's rule, G = min(subtask batch, S); under GLV each
    subtask's stream holds 2n entries."""
    from msm_tpu_torch.models.geometry import pick_geometry
    from msm_tpu_torch.params import BN254, MsmConfig

    cfg = cfg or MsmConfig(curve=BN254, compress=True)
    geo = pick_geometry(n, dataclasses.replace(cfg, compress=True))
    stream = 2 * n if cfg.glv else n
    return min(geo.subtask_batch, cfg.num_subtasks), stream // geo.num_rows, geo.num_rows


def _glv_table(aff, cfg):
    """The GLV table [m, 3D] (rows x R, beta x R, y R) of the first m/2
    affine points and their images phi(P) = (beta x, y): row m/2 + i is
    phi(P_i), so x_(m/2 + i) = beta x_i."""
    from msm_tpu_torch.ops.cuda_convert import pack_canonical
    from msm_tpu_torch.ops.glv import glv_params

    q, beta = cfg.curve.modulus, glv_params(cfg.curve).beta
    pts = aff + [(x * beta % q, y) for x, y in aff]
    cols = ([x for x, _ in pts], [x * beta % q for x, _ in pts], [y for _, y in pts])
    return torch.cat([pack_canonical(torch.from_numpy(_mont(c, cfg)), cfg) for c in cols], dim=-1)


def _glv_pair_stream(rng, G, C, R, rows):
    """perm, flags [G, C, R] over a _glv_table of ``rows`` rows, flags with
    the phi bit (bit 1) as well as the sign; planted at pair positions
    (2j, 2j+1): doublings and infinity pairs of one row and phi bit, and
    pairs of P_i's phi copy with the row phi(P_i) (equal x across the
    halves) of equal or opposite sign."""
    half = rows // 2
    perm = rng.integers(0, rows, size=(G, C, R)).astype(np.int32)
    flags = rng.integers(0, 4, size=(G, C, R)).astype(np.int32)
    kind = rng.random((G, C // 2, R))
    for planted, flip in ((kind < 0.15, 0), (kind > 0.85, 1)):
        g, j, r = np.nonzero(planted)
        perm[g, 2 * j + 1, r] = perm[g, 2 * j, r]
        flags[g, 2 * j + 1, r] = flags[g, 2 * j, r] ^ flip
    g, j, r = np.nonzero((kind >= 0.15) & (kind < 0.45))
    i = rng.integers(0, half, size=g.shape)
    sign = rng.integers(0, 2, size=g.shape)
    perm[g, 2 * j, r], flags[g, 2 * j, r] = i, 2 | sign
    perm[g, 2 * j + 1, r] = half + i
    flags[g, 2 * j + 1, r] = sign ^ (kind[g, j, r] < 0.3)
    return perm, flags


def _glv_scan_inputs(rng, n: int, G: int, R: int, cfg, dev) -> list:
    """A random canonical GLV table [n, 3D] and a stream over it as the
    payload decode gives it: per subtask a random permutation of the 2n
    entries (entry i >= n the phi copy of row i - n), step-major [G, C, R]
    with C = 2n / R; perm the row, flags bit 0 a random sign, bit 1 the phi
    bit."""
    from msm_tpu_torch.ops.cuda_convert import pack_canonical

    tab = torch.cat([pack_canonical(torch.from_numpy(_rand_fe(rng, (n,), cfg)), cfg)
                     for _ in range(3)], dim=-1).to(dev)
    C = 2 * n // R
    logical = np.stack([rng.permutation(2 * n).reshape(R, C).T for _ in range(G)])
    flags = rng.integers(0, 2, size=logical.shape) | ((logical // n) << 1)
    return [tab, *(torch.from_numpy(np.ascontiguousarray(a.astype(np.int32))).to(dev)
                   for a in (logical % n, flags))]


def check_glv_shapes(kern, rng, glv_table, dev, clock_hz) -> None:
    """The GLV modes at the GLV 2^16 MSMs' shapes, exact against their twins:
    the convert at 2^16 points and on 2^20 coordinates anywhere in [0,
    2^256); the scan at the plain GLV 2^16 shape (c = 13, S = 10: G = 4
    subtasks of C = 16 steps over R = 8192 lanes); the suffix products and
    the emission + scan at the compressed GLV 2^16 shape (G8 C64 R2048)."""
    from msm_tpu_torch.ops.field import get_field_ctx
    from msm_tpu_torch.params import BN254, MsmConfig, pick_config

    cfg = MsmConfig(curve=BN254, compress=True, glv=True)
    f, L = get_field_ctx(cfg), cfg.num_words

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    for label, n, top in (("2^16", 1 << 16, cfg.curve.modulus), ("2^20 >=p", 1 << 20, None)):
        _check_case(kern, f, L, "convert_pack_glv", label, [cfg, *map(t, _coord_words(rng, n, top))], False,
                    5, clock_hz)
    pcfg = dataclasses.replace(pick_config(1 << 16), glv=True)
    G, R = 4, 8192
    _check_case(kern, f, L, "scan_rows_glv", f"G{G} C{2 * (1 << 16) // R} R{R}",
                [pcfg, *_glv_scan_inputs(rng, 1 << 16, G, R, pcfg, dev)], False, 3, clock_hz)
    G, C, R = _compressed_shape(1 << 16, cfg)
    pair_in = [cfg, glv_table, *map(t, _glv_pair_stream(rng, G, C, R, glv_table.shape[0]))]
    _check_case(kern, f, L, "pair_suffix_glv", f"2^16 G{G} C{C} R{R}", pair_in, False, 5, clock_hz)
    _check_case(kern, f, L, "emit_scan_glv", f"2^16 G{G} C{C} R{R}", _emit_scan_args(kern, pair_in), False, 3,
                clock_hz)


def _emit_scan_args(kern, pair_in) -> list:
    """emit_scan's inputs on a pair stream: the suffix kernel's products and
    the Fermat kernel's inverse of s_0, as compressed_prefix_scan feeds it."""
    cfg = pair_in[0]
    s = kern["pair_suffix"][0](*pair_in)
    return [*pair_in, s, kern["mont_pow"][0](cfg, s[:, 0], cfg.curve.modulus - 2)]


def _backward_args(kern, pair_in) -> list:
    """pair_backward's inputs on a pair stream: the forward kernel's
    products and the Fermat kernel's inverse of the last, as compress_pairs
    feeds it."""
    cfg = pair_in[0]
    m = kern["pair_forward"][0](*pair_in)
    return [*pair_in, m, kern["mont_pow"][0](cfg, m[:, -1], cfg.curve.modulus - 2)]


def check_pair_value_shapes(kern, rng, table, dev, clock_hz) -> None:
    """Kernels 10 and 11 (compress_pairs's forward products and backward
    emission) at the compressed 2^20 MSM's shape, the suffix products'
    G16 C512 R2048, exact against their twins (check_kernels holds them at
    the TPU rule's G4 C1024 R1024, the parent's shape)."""
    from msm_tpu_torch.ops.field import get_field_ctx
    from msm_tpu_torch.params import BN254, MsmConfig

    cfg = MsmConfig(curve=BN254, compress=True)
    f, L = get_field_ctx(cfg), cfg.num_words
    G, C, R = _compressed_shape(1 << 20, cfg)
    pair_in = [cfg, table, *(torch.from_numpy(a).to(dev) for a in _pair_stream(rng, G, C, R, table.shape[0]))]
    label = f"2^20 G{G} C{C} R{R}"
    _check_case(kern, f, L, "pair_forward", label, pair_in, False, 3, clock_hz)
    _check_case(kern, f, L, "pair_backward", label, _backward_args(kern, pair_in), False, 3, clock_hz)


def check_bpr_shapes(kern, rng, dev, clock_hz) -> None:
    """Kernel 8 at the blocked reduction's 2^16 shape (pick_config(2^16):
    c = 13, 20 windows of 4096 body buckets at bpr_threads = 256 lanes, so
    Bl = 16), with planted rows (_bpr_buckets), exact against its twin
    (check_kernels holds it at G1 T16 Bl16 and the 2^20 shape)."""
    from msm_tpu_torch.models.geometry import pick_geometry
    from msm_tpu_torch.ops.field import get_field_ctx
    from msm_tpu_torch.params import pick_config

    cfg = pick_config(1 << 16)
    T = pick_geometry(1 << 16, cfg).bpr_threads
    G, Bl = cfg.num_subtasks, (cfg.num_buckets - 1) // T
    args = [cfg, *(torch.from_numpy(a).to(dev) for a in _bpr_buckets(rng, (G, Bl, T), cfg))]
    _check_case(kern, get_field_ctx(cfg), cfg.num_words, "bpr_phase1", f"2^16 G{G} T{T} Bl{Bl}", args,
                False, 3, clock_hz)


def _scaled_modes(cfg) -> list:
    """(label, x_scale, dual_x_scale, triple) of the scaled convert's
    modes: an x constant overriding R^2, two tables (x R, beta x R) sharing
    y, the triple table with an overridden first constant, the plain
    default, and the triple table with the GLV constants (convert_pack_glv's
    function, timed beside it)."""
    from msm_tpu_torch.ops.glv import glv_params

    q = cfg.curve.modulus
    beta_r2 = glv_params(cfg.curve).beta * cfg.r2 % q
    override = (SEED << 200) * cfg.r2 % q
    return [("override", override, None, False), ("dual", None, beta_r2, False),
            ("triple_override", override, beta_r2, True), ("default", None, None, False),
            ("triple", None, beta_r2, True)]


def check_convert_scaled(kern, clock_hz: float, sizes, dev) -> dict:
    """The convert kernel with run-time x constants (convert_pack_scaled)
    in its five modes against its twin, on a random stream of its own after
    every other check: at 2048 points and at 2^20, below p and (2^20)
    anywhere in [0, 2^256). Returns the two-table mode's result at 2^20
    below p, the mode no other kernel has."""
    from msm_tpu_torch.ops.field import get_field_ctx
    from msm_tpu_torch.params import BN254, MsmConfig

    rng = np.random.default_rng(SEED + 10)
    cfg = MsmConfig(curve=BN254)
    f, L, q = get_field_ctx(cfg), cfg.num_words, cfg.curve.modulus
    out = {}
    for size in sizes:
        n = 2048 if size == "small" else 1 << 20
        for top_label, top in ((("", q),) if size == "small" else (("", q), (" >=p", None))):
            words = [torch.from_numpy(a).to(dev) for a in _coord_words(rng, n, top)]
            for label, xs, xs2, triple in _scaled_modes(cfg):
                res = _check_case(kern, f, L, "convert_pack_scaled", f"{size}{top_label} {label}",
                                  [cfg, *words, xs, xs2, triple], False, 5, clock_hz)
                if label == "dual" and top is not None:
                    out["convert_pack_scaled"] = res
                    res["library_ms"] = None
    return out


def run_convert_scaled(device="cuda", curve=None, logn: int = 20, word_size: int = 13) -> dict:
    """The scaled convert driven in its five modes at 2^logn points whose
    coordinates lie anywhere in [0, 2^(32 D)), counters reset just before:
    every output equal to its twin's (BN254, or ``curve``, a
    params.CurveSpec; at ``word_size``-bit limbs). Returns the counts."""
    from msm_tpu_torch.ops.cuda_convert import coord_u16, convert_pack_scaled, convert_pack_scaled_plain
    from msm_tpu_torch.params import BN254, MsmConfig

    cfg = MsmConfig(curve=curve or BN254, word_size=word_size)
    rng = np.random.default_rng(SEED + 11 + (0 if curve is None else 500 + _curve_index(curve.name))
                                + WIDTH_SEED[word_size])
    x, y = (torch.from_numpy(a).to(device) for a in _coord_words(rng, 1 << logn, None, coord_u16(cfg)))
    modes = _scaled_modes(cfg)
    _reset_counts()
    outs = [convert_pack_scaled(cfg, x, y, xs, xs2, triple) for _, xs, xs2, triple in modes]
    torch.cuda.synchronize()
    tag = f"convert_pack_scaled{'' if curve is None else ' ' + curve.name}{_w(word_size)} 2^{logn}"
    counts = _counts_of(f"{tag} (five modes)", "convert_scaled")
    for (label, xs, xs2, triple), got in zip(modes, outs):
        want = convert_pack_scaled_plain(cfg, x, y, xs, xs2, triple)
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        if len(got) != len(want) or not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"convert_pack_scaled ({label}) differs from its twin")
    print(f"{tag}: {', '.join(m[0] for m in modes)} (coordinates anywhere below 2^(32 D)) equal the twin's "
          "tables", flush=True)
    return counts


def check_convert_emit_shapes(kern, rng, table, dev, clock_hz) -> None:
    """The two kernels redesigned on the word core at the shapes the checks
    above miss, exact against their twins: the convert kernel at 2^16
    points and on 2^20 coordinates anywhere in [0, 2^256) (unvalidated
    input; most of them >= p), and the emission + scan at the compressed
    2^16 MSM's shape (not at the TPU rule's old 2^20 shape, R = 1024
    lanes, C = 1024 steps, 4 subtasks, which no path runs)."""
    from msm_tpu_torch.ops.field import get_field_ctx
    from msm_tpu_torch.params import BN254, MsmConfig

    cfg = MsmConfig(curve=BN254, compress=True)
    f, L = get_field_ctx(cfg), cfg.num_words

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    for label, n, top in (("2^16", 1 << 16, cfg.curve.modulus), ("2^20 >=p", 1 << 20, None)):
        _check_case(kern, f, L, "convert_pack", label, [cfg, *map(t, _coord_words(rng, n, top))], False, 5,
                    clock_hz)
    for label, (G, C, R) in (("2^16", _compressed_shape(1 << 16, cfg)),):
        pair_in = [cfg, table, *map(t, _pair_stream(rng, G, C, R, table.shape[0]))]
        _check_case(kern, f, L, "emit_scan", f"{label} G{G} C{C} R{R}", _emit_scan_args(kern, pair_in), False, 3,
                    clock_hz)


def _pow_lanes(rng, G: int, R: int, cfg) -> np.ndarray:
    """Fermat kernel inputs [G, L, R]: random canonical lanes with one,
    p - 1, zero and a negated (balanced, every limb <= 0) value planted in
    lanes 0-3 of subtask 0."""
    lanes = _rand_fe(rng, (G, R), cfg)
    lanes[0, :3] = _mont([1, cfg.curve.modulus - 1, 0], cfg)
    lanes[0, 3] = -lanes[0, 3]
    return np.ascontiguousarray(lanes.transpose(0, 2, 1))


def check_suffix_pow_shapes(kern, rng, table, dev, clock_hz) -> None:
    """The two kernels redesigned in the compressed path's stage 3 at the
    shapes the checks above miss, exact against their twins: the suffix
    products at the compressed 2^16 MSM's shape (G16 C32 R2048); the Fermat
    kernel at e = p - 2 over 16 x 1024 and 16 x 4096 lanes (the 16 x 2048 of
    the 2^20 and 2^16 MSMs is checked above) and, over 16 x 2048 lanes, at
    e = 0, 1 and a 1000-bit e."""
    from msm_tpu_torch.ops.field import get_field_ctx
    from msm_tpu_torch.params import BN254, MsmConfig

    cfg = MsmConfig(curve=BN254, compress=True)
    f, L, p = get_field_ctx(cfg), cfg.num_words, cfg.curve.modulus

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    G, C, R = _compressed_shape(1 << 16, cfg)
    pair_in = [cfg, table, *map(t, _pair_stream(rng, G, C, R, table.shape[0]))]
    _check_case(kern, f, L, "pair_suffix", f"2^16 G{G} C{C} R{R}", pair_in, False, 5, clock_hz)
    e1000 = (int.from_bytes(rng.bytes(125), "little") >> 1) | (1 << 999)
    cases = [(16, 1024, p - 2, "p-2"), (16, 4096, p - 2, "p-2"), (16, 2048, 0, "0"), (16, 2048, 1, "1"),
             (16, 2048, e1000, "1000-bit")]
    for G, R, e, label in cases:
        _check_case(kern, f, L, "mont_pow", f"{G} x {R} lanes e={label}", [cfg, t(_pow_lanes(rng, G, R, cfg)), e],
                    False, 3, clock_hz)


def _of_field(mangled: str, kernel: str, field: str) -> bool:
    """Whether a mangled name is ``kernel``'s instance for the traits type
    ``field`` of csrc/fields.cuh: ``k_x`` is named ``3k_x``, and ``k_x<1>``
    is the instance of a kernel templated on the field and then on an int
    (``3k_xI<field>ELi1EE``); a kernel that is no template over the field
    is BN254's. The field is matched whole, by its length-prefixed name
    (``7FpBn254``), so no traits name matches another that it begins. The
    limb width is not in the name: each width's library has its own build
    log and objects (ops/_build.library_path), which the callers read."""
    name, _, arg = kernel.partition("<")
    if f"{len(name)}{name}" not in mangled or (arg and f"ELi{arg.rstrip('>')}EE" not in mangled):
        return False
    return f"{len(field)}{field}" in mangled if re.search(r"\dFp[A-Z]", mangled) else field == "FpBn254"


def _ptxas(log: str, kernel: str, field: str = "FpBn254") -> dict:
    """ptxas's report of ``kernel``'s instance for ``field`` (_of_field) in
    one library's build log (the limb width's): registers, stack frame and
    spill bytes."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and _of_field(line, kernel, field):
            text = " ".join(lines[i + 1:i + 4])
            frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", text)
            regs = re.search(r"Used (\d+) registers", text)
            return {"registers": int(regs.group(1)), "frame": int(frame.group(1)),
                    "spill_stores": int(frame.group(2)), "spill_loads": int(frame.group(3))}
    raise RuntimeError(f"no ptxas report for {kernel}<{field}>")


@functools.lru_cache(maxsize=None)
def _sass_functions(obj) -> dict[str, tuple[int, int]]:
    """{mangled kernel name: (instructions, CALL instructions)} of an
    object file's SASS, by cuobjdump at nice 19 (it runs beside the phases:
    _prefetch_sass) (a function's instructions are the lines that start
    with their address, ``/*0a10*/``)."""
    from msm_tpu_torch.ops import _build

    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(obj)], check=True, capture_output=True, text=True,
                          preexec_fn=lambda: os.nice(19)).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        out[name.strip()] = (len(re.findall(r"/\*[0-9a-f]+\*/\s", body)), len(re.findall(r"\bCALL\b", body)))
    return out


def _prefetch_sass(objs) -> None:
    """cuobjdump the object files all at once (seconds each, one at a time
    otherwise), filling _sass_functions' cache."""
    objs = sorted(set(objs))
    with ThreadPoolExecutor(len(objs)) as pool:
        list(pool.map(_sass_functions, objs))


def _sass_calls(obj, kernel: str, field: str = "FpBn254") -> tuple[int, int]:
    """(instructions, CALL instructions) of a kernel's SASS in an object
    file of one library (the limb width's: _sass_functions), its instance
    for ``field`` (_of_field)."""
    found = [v for k, v in _sass_functions(obj).items() if _of_field(k, kernel, field)]
    if not found:
        raise RuntimeError(f"no SASS for {kernel}<{field}> in {obj}")
    return found[0]


def _ms_each(fn, before, reps: int) -> float:
    """ms per call of fn, by CUDA events around each call alone, ``before``
    (when given) enqueued just ahead of each; all enqueued behind a spin
    kernel, after one warm-up round."""
    for step in (before, fn):
        if step:
            step()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda._sleep(200_000_000)
    for start, end in events:
        if before:
            before()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def scan_after(kern, cases) -> None:
    """The scan's time at the 2^20 shape alone, just after a histogram
    launch (128 KiB of dynamic shared memory per block) and just after a
    row-offsets launch (three kernels of large stack frames), each twice in
    turns: the scan's source has read up to 10% apart between builds and
    between runs, and this tells a neighbour's effect from the scan's own."""
    def launch(name):
        wrapper, args = kern[name][0], cases[name][0]
        return lambda: wrapper(*args)

    scan = launch("scan_rows")
    before = {"alone": None, "after_bucket_hist": launch("bucket_hist"),
              "after_row_offsets": launch("row_offsets")}
    runs = {label: [] for label in before}
    for _ in range(2):
        for label, fn in before.items():
            runs[label].append(_ms_each(scan, fn, 5))
    print("scan_rows slice ms " + "; ".join(f"{k}={', '.join(f'{v:.4f}' for v in vs)}"
                                            for k, vs in runs.items()), flush=True)


def _bincount_ms(keys, nb) -> float:
    """ms of torch.bincount over keys [G, n] offset by g * nb: the one
    PyTorch call that computes the histogram kernel's function."""
    flat = (keys.long() + torch.arange(keys.shape[0], device=keys.device)[:, None] * nb).reshape(-1)
    return _kernel_ms(lambda: torch.bincount(flat, minlength=keys.shape[0] * nb), 5)[1]


def check_path_shapes(kern, rng, base, dev, clock_hz) -> None:
    """The kernels at the other shapes that the naive and blocked paths at
    2^20 give them, held exact against their twins as in check_kernels:
    the naive histogram (32 windows of 2^20 8-bit keys into 256 buckets,
    with torch.bincount's time beside it), the running sum's point adds
    (32 windows), bucket_accumulate's (32 x 256 buckets; also the shape of
    the blocked tail's 16 x 512 suffix ladder), 16 windows of P + P, the
    blocked tail's point totals (16 x 512 real points), and the Horner
    kernel over the 16 windows' two-point folds at chunk 15
    (window_sum_from_pe at c = 16)."""
    from msm_tpu_torch.models.geometry import pick_geometry
    from msm_tpu_torch.models.naive import NAIVE_CONFIG
    from msm_tpu_torch.ops.field import get_field_ctx
    from msm_tpu_torch.params import pick_config

    cfg = pick_config(1 << 20)
    f, L = get_field_ctx(cfg), cfg.num_words
    S, T = cfg.num_subtasks, pick_geometry(1 << 20, cfg).bpr_threads
    nS, nb = NAIVE_CONFIG.num_subtasks, 1 << NAIVE_CONFIG.chunk_size

    def t(a):
        return torch.from_numpy(a).to(dev)

    def fe(batch):
        return [t(_rand_fe(rng, (batch,), cfg)) for _ in range(6)]

    keys = t(rng.integers(0, nb, size=(nS, 1 << 20), dtype=np.int32))
    dbl = fe(S)[:3]
    cases = [
        ("bucket_hist", "naive", [NAIVE_CONFIG, keys, nb], False, 3),
        ("point_add", "naive_running", [cfg, *fe(nS)], False, 5),
        ("point_add", "naive_accumulate", [cfg, *fe(nS * nb)], False, 5),
        ("point_add", "blocked_doubling", [cfg, *dbl, *dbl], False, 5),
        ("point_total", "blocked_tail", [cfg, *_curve_points(rng, (S, T), cfg, base, dev)], True, 3),
    ]
    fold = [t(_rand_fe(rng, (S, 2), cfg)) for _ in range(3)]
    cases.append(("horner", f"fold G{S} S2 chunk{cfg.chunk_size - 1}", [cfg, *fold, cfg.chunk_size - 1],
                  False, 5))
    for name, label, args, as_points, reps in cases:
        _check_case(kern, f, L, name, label, args, as_points, reps, clock_hz)
    print(f"library bucket_hist naive torch.bincount ms={_bincount_ms(keys, nb):.4f}", flush=True)


def _skewed_keys(rng, rows: int, n: int, nb: int, top: int) -> np.ndarray:
    """Keys [rows, n] as the padded input of 2^19 + 1 points gives at
    n = 2^20: the first n/2 + 1 keys of each row uniform in [0, nb), the
    rest 0 (zero scalars); the last row only in [0, top), a top window's
    narrow range."""
    keys = np.zeros((rows, n), dtype=np.int32)
    keys[:, : n // 2 + 1] = rng.integers(0, nb, size=(rows, n // 2 + 1))
    keys[-1, : n // 2 + 1] = rng.integers(0, top, size=n // 2 + 1)
    return keys


def check_redesigned_shapes(kern, rng, base, dev, clock_hz) -> None:
    """The redesigned kernels at shapes the uniform checks miss, exact
    against their twins, the histogram with torch.bincount's time beside
    each: skewed keys at the plain 2^20 shape (16 x 2^20 keys, 32769
    buckets) and the naive one (32 x 2^20, 256 buckets); 16 x 2^20 uniform
    keys over 65536 buckets (unsigned 16-bit windows), whose counters exceed
    a block's shared memory, so the kernel tiles the bucket range; the row
    offsets on real points at R = 8 (the n = 35 edge MSM), 1024
    (compressed) and 8192 (2^16 plain) lanes, 4 subtasks, and at R = 16384
    over 8 and 16 subtasks, where the plan gives 4 and 8 lanes per thread
    (the kernel's 16-byte loads); the scan, the point total, the Horner
    ladder and the window sums' fold at the plain 2^16 MSM's shapes."""
    from msm_tpu_torch.models.naive import NAIVE_CONFIG
    from msm_tpu_torch.ops.cuda_prefix import row_offsets_plan
    from msm_tpu_torch.ops.field import get_field_ctx
    from msm_tpu_torch.params import BN254, MsmConfig, pick_config

    cfg, ncfg = pick_config(1 << 20), NAIVE_CONFIG
    f, L = get_field_ctx(cfg), cfg.num_words
    n, order = 1 << 20, BN254.order
    # the top window's digits: the scalar's top bits, plus a carry when signed
    top = (order >> (cfg.chunk_size * (cfg.num_subtasks - 1))) + 2
    ntop = (order >> (ncfg.chunk_size * (ncfg.num_subtasks - 1))) + 1
    hist = {
        "plain_skew": [cfg, _skewed_keys(rng, cfg.num_subtasks, n, cfg.num_buckets, top), cfg.num_buckets],
        "naive_skew": [ncfg, _skewed_keys(rng, ncfg.num_subtasks, n, 256, ntop), 256],
        "unsigned16": [MsmConfig(curve=BN254), rng.integers(0, 1 << 16, size=(16, n), dtype=np.int32), 1 << 16],
    }
    for label, (hcfg, keys, nb) in hist.items():
        keys = torch.from_numpy(keys).to(dev)
        _check_case(kern, f, L, "bucket_hist", label, [hcfg, keys, nb], False, 5, clock_hz)
        print(f"library bucket_hist {label} torch.bincount ms={_bincount_ms(keys, nb):.4f}", flush=True)
    for G, R in ((4, 8), (4, 1024), (4, 8192), (8, 1 << 14), (16, 1 << 14)):
        k = row_offsets_plan(G, R).lanes_per_thread
        rows = _curve_points(rng, (G, R), cfg, base, dev)
        args = [cfg, *(a.transpose(1, 2).contiguous() for a in rows)]
        _check_case(kern, f, L, "row_offsets", f"R{R} G{G} k{k}", args, True, 3, clock_hz)
    check_word_core_shapes(kern, rng, base, dev, clock_hz)


def check_word_core_shapes(kern, rng, base, dev, clock_hz) -> None:
    """The word-core kernels at the plain 2^16 MSM's shapes (c = 13), exact
    against their twins: the scan (G = 4 subtasks of C = 8 steps over R =
    8192 lanes), the point total over 20 windows of 4096 real points, the
    Horner ladder over S = 20 windows and the 20 windows' two-point folds
    at chunk 12."""
    from msm_tpu_torch.ops.cuda_convert import pack_canonical
    from msm_tpu_torch.ops.field import get_field_ctx
    from msm_tpu_torch.params import pick_config

    cfg = pick_config(1 << 16)
    f, L = get_field_ctx(cfg), cfg.num_words
    G, C, R = 4, 8, 8192
    n = C * R
    tab = torch.cat([pack_canonical(torch.from_numpy(_rand_fe(rng, (n,), cfg)), cfg)
                     for _ in range(2)], dim=-1).to(dev)
    perm = np.stack([rng.permutation(n).reshape(R, C).T for _ in range(G)]).astype(np.int32)
    flags = rng.integers(0, 2, size=perm.shape, dtype=np.int32)
    args = [cfg, tab, *(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (perm, flags))]
    _check_case(kern, f, L, "scan_rows", f"G{G} C{C} R{R}", args, False, 3, clock_hz)
    S, chunk = cfg.num_subtasks, cfg.chunk_size
    ws = [torch.from_numpy(_rand_fe(rng, (S,), cfg)).to(dev) for _ in range(3)]
    _check_case(kern, f, L, "horner", f"S{S} chunk{chunk}", [cfg, *ws, chunk], False, 3, clock_hz)
    N = cfg.num_buckets - 1
    _check_case(kern, f, L, "point_total", f"G{S} N{N}", [cfg, *_curve_points(rng, (S, N), cfg, base, dev)],
                True, 5, clock_hz)
    fold = [torch.from_numpy(_rand_fe(rng, (S, 2), cfg)).to(dev) for _ in range(3)]
    _check_case(kern, f, L, "horner", f"fold G{S} S2 chunk{chunk - 1}", [cfg, *fold, chunk - 1], False, 5,
                clock_hz)


def sample_msm(n: int, seed: int = SEED):
    """1024 distinct points tiled to n, uniform scalars (numpy seed)."""
    from msm_tpu_torch.oracle.pyecc import Curve
    from msm_tpu_torch.params import BN254

    cv = Curve(BN254)
    nbase = min(n, 1024)
    base = [cv.to_affine(p) for p in cv.sample_points(nbase, seed=seed)]
    rng = np.random.default_rng(seed + 1)
    raw = rng.integers(0, 1 << 63, size=(n, 4), dtype=np.uint64)
    ks = [int.from_bytes(r.tobytes(), "little") % BN254.order for r in raw]
    return base, [base[i % nbase] for i in range(n)], ks


def folded_oracle(base, ks):
    """The exact MSM of tiled points: scalars folded per base point mod r."""
    from msm_tpu_torch.oracle import best_msm
    from msm_tpu_torch.params import BN254

    nb = len(base)
    folded = [0] * nb
    for i, k in enumerate(ks):
        folded[i % nb] += k
    return best_msm(base, [k % BN254.order for k in folded])


def msm_path(path: str, n: int, device="cuda", curve=None, word_size: int = 13):
    """(config, run) of an MSM path on ``curve`` (a params.CurveSpec; BN254
    by default) at ``word_size``-bit limbs: run(points, scalars) -> affine
    (x, y) or None, through the entry point a user calls."""
    import msm_tpu_torch
    from msm_tpu_torch.models import common
    from msm_tpu_torch.models.naive import NAIVE_CONFIG, compute_msm_naive
    from msm_tpu_torch.params import BN254, MsmConfig, pick_config

    if path == "naive":  # 8-bit unsigned windows on any curve
        ncfg = NAIVE_CONFIG if curve is None else dataclasses.replace(NAIVE_CONFIG, curve=curve)
        ncfg = dataclasses.replace(ncfg, word_size=word_size)
        return ncfg, lambda pts, ks: common.result_to_affine(
            compute_msm_naive(pts, ks, config=ncfg, device=device), ncfg)
    curve = curve or BN254
    cfg = {"plain": pick_config(n, curve), "compressed": MsmConfig(curve=curve, compress=True),
           "glv": dataclasses.replace(pick_config(n, curve), glv=True),
           "glv_compressed": MsmConfig(curve=curve, compress=True, glv=True)}[path]
    cfg = dataclasses.replace(cfg, word_size=word_size)
    return cfg, lambda pts, ks: msm_tpu_torch.run_gpu_msm(pts, ks, config=cfg, device=device)


def stage_times(pts, ks, cfg, path, device="cuda") -> dict:
    """One MSM split into its stages, each ended by a synchronize (ms); the
    cuZK paths' scalar decomposition is a stage of its own, and under GLV
    the scalar split (ops/glv.split_scalars_device) one before it."""
    from msm_tpu_torch.models import common, cuzk, naive
    from msm_tpu_torch.models.geometry import pick_geometry
    from msm_tpu_torch.ops import glv

    st = {}

    def mark(name, t0):
        torch.cuda.synchronize()
        st[name] = (time.perf_counter() - t0) * 1e3
        return time.perf_counter()

    t0 = time.perf_counter()
    x, y, s = common.pad_inputs(pts, ks, cfg)
    t0 = mark("host_serialize", t0)
    xd, yd, sd = (torch.from_numpy(a).to(device) for a in (x, y, s))
    t0 = mark("upload", t0)
    st["upload_points_MiB"] = (x.nbytes + y.nbytes) / 2**20
    st["upload_scalars_MiB"] = s.nbytes / 2**20
    packed = common.prepare_points(cfg, xd, yd)
    t0 = mark("convert", t0)
    geom = pick_geometry(x.shape[0], cfg)
    if path == "naive":
        ws = naive.naive_window_sums(packed, sd, cfg, geom)
        t0 = mark("window_sums", t0)
        naive.naive_result(ws, cfg)
        mark("export_host_horner", t0)
        return st
    if cfg.glv:
        split = glv.split_scalars_device(sd, cfg)
        t0 = mark("glv_split", t0)
        keys, signs = glv.decompose_halves(split, cfg.chunk_size, cfg.num_subtasks)
    else:
        keys, signs = cuzk.decompose_scalars(sd, cfg)
    t0 = mark("decompose", t0)
    ws = cuzk.window_sums_from_keys(packed, keys, signs, cfg, geom)
    t0 = mark("window_sums", t0)
    common.std_ints_to_jpoint(*cuzk.msm_point_from_ws(ws, cfg), cfg)
    mark("horner_and_host_tail", t0)
    return st


def device_breakdown(run, pts, ks, trace_path) -> tuple[float, float, dict]:
    """One MSM under torch.profiler: (wall ms, device-busy ms, device ms by
    kernel). Busy time is the union of the device's kernel and copy
    intervals; kernels of this package keep their names (a wrapper's several
    kernels summed under one, TRACE_ROWS), PyTorch's own kernels (sort,
    gathers, elementwise) are summed as "torch_ops". A trace must hold every
    kernel the wrappers launched (launches x the kernels per launch,
    TRACE_KERNELS; the profiler has been seen to drop device events); an
    incomplete one is taken again, at most three times. Only the device
    events that start within the MSM's own span (a user annotation around
    it) count."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from msm_tpu_torch.ops.cuda_curve import point_add
    from msm_tpu_torch.params import BN254, MsmConfig

    kern = _kernels()
    zero = torch.zeros((1, MsmConfig(curve=BN254).num_words), dtype=torch.int32, device="cuda")
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            # a trace has been seen to miss its first kernel when the MSM's
            # first launch came ~60 ms after the trace began (2^16), and
            # (with a zero fill first) this package's first kernel on a
            # slower host: a fill and one point add of zero rows go first,
            # outside the MSM's span
            torch.zeros(1, device="cuda")
            point_add(MsmConfig(curve=BN254), *[zero] * 6)
            torch.cuda.synchronize()
            _reset_counts()
            with record_function("chip_smoke_msm"):
                t0 = time.perf_counter()
                run(pts, ks)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            # the device's last records reach a trace that stops at once
            # after them late or not at all (seen once the host tail took
            # ~1 ms instead of ~20 ms)
            time.sleep(0.1)
        trace_path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace_path))
        events = json.loads(trace_path.read_text())["traceEvents"]
        start = min(e["ts"] for e in events if e.get("name") == "chip_smoke_msm")
        events = [e for e in events if e.get("ts", start) >= start]
        busy_ms, by_name, n_ours = trace_breakdown(events)
        counts = {name: w.launches for name, (w, _plain) in kern.items()}
        expected = sum(n * len(TRACE_KERNELS.get(name, (name,))) for name, n in counts.items())
        if n_ours == expected:
            return wall_ms, busy_ms, by_name
        seen: dict[str, int] = {}
        for e in events:
            if e.get("ph") == "X" and e.get("cat") == "kernel" and _our_kernel(e["name"]):
                seen[_our_kernel(e["name"])] = seen.get(_our_kernel(e["name"]), 0) + 1
        print(f"profiled MSM: trace holds {n_ours} of {expected} kernel launches ({json.dumps(seen)} "
              f"for launches {json.dumps({k: v for k, v in counts.items() if v})}); again", flush=True)
    raise RuntimeError("the profiler dropped kernel events in three traces")


def _our_kernel(name: str) -> str | None:
    """This package's kernel named by a trace event, without its field
    ("k_scan" for "k_scan(int const*, ...)" and for "void
    msm::k_scan<msm::FpPallas>(int const*, ...)"); None for another's."""
    m = re.match(r"(?:void )?(?:msm::)?(k_\w+)", name)
    return m.group(1) if m else None


def trace_breakdown(events) -> tuple[float, dict, int]:
    """(device-busy ms, device ms by kernel, number of this package's kernel
    events) of a chrome trace's events."""
    by_name: dict[str, float] = {}
    spans = []
    n_ours = 0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        ours = _our_kernel(e["name"])
        name = ours or e["name"].split("(")[0]
        n_ours += ours is not None
        key = TRACE_ROWS.get(name, name) if ours else "memcpy" if e["cat"] != "kernel" else "torch_ops"
        by_name[key] = by_name.get(key, 0.0) + e["dur"] / 1e3
        spans.append((e["ts"], e["ts"] + e["dur"]))
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return busy / 1e3, by_name, n_ours


def edge_checks(path: str, device="cuda", word_size: int = 13) -> None:
    """Small MSMs through the kernels of a path (plain: pick_config):
    n = 35 (padded to 64) with repeated points and scalars at the recode
    edges and out of range; P and -P interleaved under one scalar (infinity
    pairs in every bucket; identity result); duplicates, negatives and
    other points mixed; k P + (r - k) P; the empty MSM. On the GLV paths
    also: lambda, r - lambda and scalars whose k1 or k2 is negative; P
    beside phi(P) and -phi(P) (a point of the input that is phi of another:
    equal x across the table's halves); k phi(P) + (r - k lambda) P, the
    identity. At ``word_size``-bit limbs."""
    from msm_tpu_torch.oracle import best_msm
    from msm_tpu_torch.oracle.pyecc import Curve
    from msm_tpu_torch.ops.glv import glv_params, split_scalar
    from msm_tpu_torch.params import BN254

    cv, r, q = Curve(BN254), BN254.order, BN254.modulus
    base = [cv.to_affine(p) for p in cv.sample_points(12, seed=SEED)]
    neg = [(x, q - y) for x, y in base]

    def run(pts, ks):
        return msm_path(path, len(pts), device, word_size=word_size)[1](pts, ks)

    def oracle(pts, ks):
        want = best_msm(pts, [k % r for k in ks])
        return None if want.is_identity() else cv.to_affine(want)

    pts = [base[i % 12] for i in range(35)]
    ks = [0, 1, r - 1, r, r + 5, 2 * r - 1, (1 << 256) - 1, -3] + list(range(10**6, 10**6 + 27))
    cases = {"edge scalars": (pts, ks)}
    cases["P, -P under one scalar"] = ([base[0], neg[0]] * 32, [12345] * 64)
    cases["duplicates and negatives"] = (
        [base[i % 3] if i % 4 else neg[i % 3] for i in range(90)] + base[3:],
        [777 + (i % 5) for i in range(90)] + list(range(9)))
    cases["k P + (r - k) P"] = ([base[0], base[0], base[1]], [5, r - 5, 0])
    identities = ["P, -P under one scalar", "k P + (r - k) P"]
    if path.startswith("glv"):
        g = glv_params(BN254)
        rng = np.random.default_rng(SEED + 3)
        rand = [int.from_bytes(rng.bytes(32), "little") % r for _ in range(400)]
        split = [(k, split_scalar(k, g, r)) for k in rand]
        neg1 = [k for k, (k1, k2) in split if k1 < 0 and k2 >= 0][:8]
        neg2 = [k for k, (k1, k2) in split if k2 < 0 and k1 >= 0][:8]
        both = [k for k, (k1, k2) in split if k1 < 0 and k2 < 0][:8]
        ks = [g.lam, r - g.lam, 0, 1, r - 1] + neg1 + neg2 + both
        cases["lambda, r - lambda, negative halves"] = ([base[i % 12] for i in range(len(ks))], ks)
        phi = [(x * g.beta % q, y) for x, y in base]
        cases["P beside phi(P) and -phi(P)"] = (
            [p for i in range(12) for p in (base[i], phi[i], (phi[i][0], q - phi[i][1]))] * 3,
            [3 + (i % 7) for i in range(108)])
        cases["k phi(P) + (r - k lambda) P"] = ([phi[0], base[0]] * 4, [11, (r - 11 * g.lam) % r] * 4)
        identities.append("k phi(P) + (r - k lambda) P")
        if not (neg1 and neg2 and both):
            raise AssertionError("no scalars with negative GLV halves drawn")
    for label, (pts, ks) in cases.items():
        got, want = run(pts, ks), oracle(pts, ks)
        if got != want:
            raise AssertionError(f"{label} MSM differs from the oracle: {got} != {want}")
    if any(oracle(*cases[label]) is not None for label in identities):
        raise AssertionError("identity cases lost their identity")
    if run([], []) is not None:
        raise AssertionError("empty MSM should be the identity")
    print(f"edge MSMs ({path}{'' if word_size == 13 else f' w{word_size}'}: {', '.join(cases)}, n = 0): bit-exact",
          flush=True)


def check_pairs(glv: bool = False, device="cuda", curve=None, word_size: int = 13) -> dict:
    """compress_pairs on the card, counters reset just before: every pair
    sum and every infinity flag against the oracle (the sums of all signed
    elements precomputed), and only the path's kernels launched. Without
    GLV at the TPU rule's compressed 2^20 shape (4 subtasks, C = 1024
    steps, R = 1024 lanes) over 16 points with planted doubling and
    infinity pairs; under GLV at the GLV compressed 2^20 shape (8 subtasks,
    C = 1024, R = 2048) over a table of 8 points and their phi images, an
    element taking x or beta x by flag bit 1, with planted doubling,
    infinity and equal-x-across-halves pairs. On another ``curve`` (a
    params.CurveSpec) at the shape of its compressed (or GLV compressed)
    2^16 MSM over its own points. At ``word_size``-bit limbs. Returns the
    counts."""
    from msm_tpu_torch.oracle.pyecc import Curve
    from msm_tpu_torch.params import BN254, MsmConfig
    from msm_tpu_torch.ops.cuda_compress import compress_pairs
    from msm_tpu_torch.ops.cuda_convert import pack_canonical
    from msm_tpu_torch.ops.field import get_field_ctx
    from msm_tpu_torch.ops.glv import glv_params

    spec = curve or BN254
    cfg = MsmConfig(curve=spec, compress=True, glv=glv, word_size=word_size)
    f, cv, q = get_field_ctx(cfg), Curve(spec), spec.modulus
    beta = glv_params(spec).beta
    seed = SEED if curve is None else SEED + 400 + 2 * _curve_index(spec.name) + WIDTH_SEED[word_size]
    if glv:
        aff = [cv.to_affine(p) for p in cv.sample_points(8, seed=seed + 12)]
        table = _glv_table(aff, cfg)
        aff = aff + [(x * beta % q, y) for x, y in aff]  # the table's rows
        rng, shape, phis = np.random.default_rng(seed + 13), (8, 1024, 2048), 2
        perm, flags = _glv_pair_stream(rng, *(shape if curve is None else _compressed_shape(1 << 16, cfg)),
                                       len(aff))
    else:
        aff = [cv.to_affine(p) for p in cv.sample_points(16, seed=seed + 7)]
        table = torch.cat([pack_canonical(torch.from_numpy(_mont(c, cfg)), cfg) for c in zip(*aff)], dim=-1)
        rng, shape, phis = np.random.default_rng(seed + 8), (4, 1024, 1024), 1
        perm, flags = _pair_stream(rng, *(shape if curve is None else _compressed_shape(1 << 16, cfg)),
                                   len(aff))
    shape = perm.shape
    rows = len(aff)
    # element k = row + rows (phi bit) + rows phis (sign): its affine point
    elems = [(x * beta ** phi % q, (q - y) % q if sign else y)
             for sign in (0, 1) for phi in range(phis) for x, y in aff]
    sums = [[cv.add(cv.from_affine(*a), cv.from_affine(*b)) for b in elems] for a in elems]
    inf_want = np.array([[sm.z % q == 0 for sm in row] for row in sums])
    xy = [[(0, 0) if sm.z % q == 0 else cv.to_affine(sm) for sm in row] for row in sums]
    dbl_kind = np.array([[a == b for b in elems] for a in elems])
    cross_kind = np.array([[a[0] == b[0] and ka % rows != kb % rows for kb, b in enumerate(elems)]
                           for ka, a in enumerate(elems)])
    dev = torch.device(device)
    n_el = len(elems)
    want_x, want_y = (torch.from_numpy(_mont([v[i] for row in xy for v in row], cfg).reshape(n_el, n_el, -1)).to(dev)
                      for i in range(2))
    tag = (f"compress_pairs{'' if curve is None else ' ' + spec.name}{' GLV' if glv else ''}{_w(word_size)} "
           f"G{shape[0]} C{shape[1]} R{shape[2]}")
    args = [table.to(dev), *(torch.from_numpy(a).to(dev) for a in (perm, flags))]
    _reset_counts()
    cx, cy, inf = compress_pairs(cfg, *args)
    torch.cuda.synchronize()
    counts = _counts_of(tag, "pairs_glv" if glv else "pairs")
    k = torch.from_numpy(perm + rows * ((flags >> 1) & 1) + rows * phis * (flags & 1)).to(dev).long()
    k1, k2 = k[:, 0::2], k[:, 1::2]  # [G, Cp, R]
    want_inf = torch.from_numpy(inf_want).to(dev)[k1, k2]
    if not torch.equal(inf.bool(), want_inf):
        raise AssertionError(f"{tag}: {int((inf.bool() != want_inf).sum())} infinity flags differ from the oracle")
    ok = ~want_inf
    for got, want in ((cx, want_x), (cy, want_y)):
        g = f.canonical(got.transpose(-1, -2))[ok]
        if not torch.equal(g, want[k1, k2][ok]):
            raise AssertionError(f"{tag}: pair sums differ from the oracle")
    n_inf = int(want_inf.sum())
    n_dbl = int(torch.from_numpy(dbl_kind).to(dev)[k1, k2].sum())
    n_cross = int(torch.from_numpy(cross_kind).to(dev)[k1, k2].sum())
    print(f"{tag}: {k1.numel()} pair sums and flags equal the oracle ({n_dbl} doublings, {n_inf} infinity "
          f"pairs, {n_cross} of equal x across rows)", flush=True)
    if not (n_dbl and n_inf and (n_cross or not glv)):
        raise AssertionError(f"{tag}: the planted pairs are missing")
    return counts


def _counts_of(tag: str, path: str) -> dict:
    """The launch counts since the last reset; raises when a kernel of the
    path did not run or a kernel the path must not reach did."""
    counts = {name: w.launches for name, (w, _) in _kernels().items()}
    print(f"{tag}: launches {json.dumps(counts)}", flush=True)
    missing = [k for k in PATHS[path] if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{tag}: kernels of the path not launched: {missing}")
    stray = [k for k in EXCLUDED.get(path, ()) if counts[k] > 0]
    if stray:
        raise AssertionError(f"{tag}: kernels outside the path launched: {stray}")
    return counts


def run_msm_checks(log_sizes=(20, 16), device="cuda") -> tuple[dict, dict]:
    """The plain, compressed, naive, GLV and GLV compressed paths at each
    size: 2^20 with counters reset just before each run, 2^16 against the
    full oracle, and end-to-end timings; at 2^20 also the blocked stage 4
    (check_blocked) on the same inputs and oracle. Returns ({path: launch
    counts of its 2^20 run}, {log2 n: (bases, points, scalars, oracle
    JPoint)})."""
    from msm_tpu_torch.oracle import best_msm
    from msm_tpu_torch.oracle.pyecc import Curve
    from msm_tpu_torch.ops._build import BUILD_ROOT
    from msm_tpu_torch.params import BN254

    cv = Curve(BN254)
    results, inputs = {}, {}
    for logn in log_sizes:
        n = 1 << logn
        t0 = time.perf_counter()
        base, pts, ks = sample_msm(n)
        # 2^20: the folded oracle over the bases; smaller: the oracle MSM over
        # every point
        want = folded_oracle(base, ks) if n > 1 << 16 else best_msm(pts, ks)
        inputs[logn] = (base, pts, ks, want)
        print(f"msm 2^{logn}: inputs + oracle {time.perf_counter() - t0:.1f} s", flush=True)
        for path in ("plain", "compressed", "naive", "glv", "glv_compressed"):
            cfg, run = msm_path(path, n, device)
            tag = f"msm 2^{logn} {path} (c={cfg.chunk_size} S={cfg.num_subtasks})"
            _reset_counts()
            t0 = time.perf_counter()
            got = run(pts, ks)
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
            counts = _counts_of(tag, path)
            print(f"{tag}: first call {first:.3f} s", flush=True)
            if want.is_identity() or got is None or cv.to_affine(want) != tuple(got):
                raise AssertionError(f"{tag} differs from the oracle: {got}")
            if logn == log_sizes[0]:
                results[path] = counts
            walls = []
            torch.cuda.reset_peak_memory_stats()
            for _ in range(3):
                t0 = time.perf_counter()
                again = run(pts, ks)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                if again != got:
                    raise AssertionError("repeat MSM differs")
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            st = stage_times(pts, ks, cfg, path, device)
            print(f"{tag}: bit-exact; wall_s median of 3 = {statistics.median(walls):.4f} "
                  f"(runs {', '.join(f'{w:.4f}' for w in walls)}); peak_mem_gib={peak_gib:.3f}; "
                  "stages_ms " + ", ".join(f"{k}={v:.1f}" for k, v in st.items()), flush=True)
            wall_ms, busy_ms, by_name = device_breakdown(
                run, pts, ks, BUILD_ROOT / f"trace_2e{logn}_{path}.json")
            print(f"{tag}: profiled wall_ms={wall_ms:.1f} device_busy_ms={busy_ms:.1f} "
                  f"kernel_ms={busy_ms - by_name.get('memcpy', 0.0):.1f} "
                  f"idle_share={1 - busy_ms / wall_ms:.3f}; device_ms "
                  + ", ".join(f"{k}={v:.2f}" for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])),
                  flush=True)
            if cfg.compress:
                print_compressed_geometry(n, cfg, by_name, counts)
        if logn == log_sizes[0]:
            results["blocked"] = check_blocked(pts, ks, want, device)
    return results, inputs


#: the compressed path's stage-3 kernels (a boundary prefix's two point
#: adds included) by their rows in the device breakdown
STAGE3_COMPRESSED = ("k_pair_suffix", "k_mont_pow", "k_emit_scan", "k_row_offsets", "k_point_add",
                     "k_point_add_lanes")


def print_compressed_geometry(n: int, cfg, by_name: dict, counts: dict) -> None:
    """One line: the compressed MSM's geometry at n (R, C, subtasks per
    launch) and its stage-3 device time by kernel, from a profiled run (a
    GLV config's from its GLV modes)."""
    G, C, R = _compressed_shape(n, cfg)
    mode = "_glv" if cfg.glv else ""
    rows = [k + mode if k in ("k_pair_suffix", "k_emit_scan") else k for k in STAGE3_COMPRESSED]
    ms = {k: by_name.get(k, 0.0) for k in rows}
    print(f"compressed{' GLV' if cfg.glv else ''} geometry 2^{n.bit_length() - 1}: R={R} C={C} batch={G} "
          f"launches emit_scan{mode}={counts['emit_scan' + mode]}; stage-3 device ms "
          + ", ".join(f"{k}={v:.3f}" for k, v in ms.items()) + f", sum={sum(ms.values()):.3f}", flush=True)


def check_blocked(pts, ks, want, device="cuda", curve=None, word_size: int = 13) -> dict:
    """The reference-shaped stage 4 on the plain config (pick_config: c = 16,
    S = 16, B = 2^15 + 1 buckets, T = bpr_threads lanes), counters reset just
    before: convert, signed decomposition, bucket_accumulate over every
    window, bucket_reduce_blocked (kernel 8 and its tail), Horner. Its window
    sums must equal window_sum_from_pe's on freshly taken boundary prefixes
    of the same points (by cross-multiplication) and its MSM the oracle's.
    Prints the device time of both stage-4 reductions. On ``curve`` (a
    params.CurveSpec; BN254 by default) with its pick_config, at
    ``word_size``-bit limbs. Returns the counts."""
    from msm_tpu_torch.models import common, cuzk
    from msm_tpu_torch.models.geometry import pick_geometry
    from msm_tpu_torch.ops import scan
    from msm_tpu_torch.ops.curve import get_curve_ctx
    from msm_tpu_torch.ops.decompose import decompose_signed
    from msm_tpu_torch.oracle.pyecc import Curve
    from msm_tpu_torch.params import pick_config

    n = common.pad_size(len(pts))
    cfg = pick_config(n) if curve is None else pick_config(n, curve)
    cfg = dataclasses.replace(cfg, word_size=word_size)
    ec, geom = get_curve_ctx(cfg), pick_geometry(n, cfg)
    batch = min(geom.subtask_batch, cfg.num_subtasks)
    tag = (f"blocked stage 4{'' if curve is None else ' ' + curve.name}{_w(word_size)} 2^{n.bit_length() - 1} "
           f"(c={cfg.chunk_size} T={geom.bpr_threads})")
    xd, yd, sd = (torch.from_numpy(a).to(device) for a in common.pad_inputs(pts, ks, cfg))
    _reset_counts()
    packed = common.prepare_points(cfg, xd, yd)
    keys, signs = decompose_signed(sd, cfg.chunk_size, cfg.num_subtasks)
    buckets = scan.bucket_accumulate(ec, packed, keys, signs, cfg.num_buckets, geom.num_rows, batch)
    w = scan.bucket_reduce_blocked(ec, buckets, geom.bpr_threads)
    pt = cuzk.msm_point_from_ws(torch.stack([w.x, w.y, w.z], dim=1), cfg)
    torch.cuda.synchronize()
    counts = _counts_of(tag, "blocked")
    got = common.std_ints_to_jpoint(*pt, cfg)
    cv = Curve(cfg.curve)
    if got.is_identity() or cv.to_affine(got) != cv.to_affine(want):
        raise AssertionError(f"{tag}: the MSM differs from the oracle")
    pe = scan.bucket_boundary_prefix(ec, packed, keys, signs, cfg.num_buckets, geom.num_rows, batch)
    tele = scan.window_sum_from_pe(ec, pe)
    err = _compare(ec.f, tuple(w), tuple(tele), as_points=True)
    if err != 0:
        raise AssertionError(f"{tag}: window sums differ from the telescoped ones: {err}")
    _, blocked_ms = _kernel_ms(lambda: scan.bucket_reduce_blocked(ec, buckets, geom.bpr_threads), 3)
    _, tele_ms = _kernel_ms(lambda: scan.window_sum_from_pe(ec, pe), 3)
    print(f"{tag}: {cfg.num_subtasks} window sums equal the telescoped ones; MSM bit-exact; "
          f"stage-4 device ms blocked={blocked_ms:.3f} telescoped={tele_ms:.3f}", flush=True)
    return counts


def _median_ms(fn, reps: int) -> tuple[float, list[float]]:
    """(median, every run) of ``reps`` calls of fn, host clock, each ended
    by a synchronize (ms)."""
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls), walls


def random_scalar_words(rng, n: int) -> np.ndarray:
    """n uniform scalars below r as u16 words [n, 16] (the top word below
    r's, so every scalar is below r)."""
    from msm_tpu_torch.params import BN254

    words = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.uint16)
    words[:, 15] = rng.integers(0, BN254.order >> 240, size=n)
    return words


def batch_sets(base, n: int, sets: int, seed: int):
    """``sets`` scalar sets as u16 words [n, 16] (random_scalar_words) and
    each one's exact MSM over the tiled points (the folded oracle)."""
    from msm_tpu_torch import bench

    rng = np.random.default_rng(seed)
    return [(w, bench.folded_oracle(base, w)) for w in (random_scalar_words(rng, n) for _ in range(sets))]


def plan_build_stages(pts, cfg, device="cuda") -> dict:
    """A plan's build split into its stages, each ended by a synchronize
    (ms): what MsmPlan's constructor runs, step by step."""
    from msm_tpu_torch.models import common

    st = {}
    t0 = time.perf_counter()
    x, y = common.pad_points_words(pts, cfg, common.pad_size(len(pts)))
    st["serialize_points"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    xd, yd = (torch.from_numpy(a).to(device) for a in (x, y))
    torch.cuda.synchronize()
    st["upload"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    common.prepare_points(cfg, xd, yd)
    torch.cuda.synchronize()
    st["convert"] = (time.perf_counter() - t0) * 1e3
    return st


def plan_stage_times(plan, words) -> dict:
    """One plan call on u16 words split into its stages, each ended by a
    synchronize (ms): host_pack into the pinned buffer, the upload of the
    packed words (with its MiB), their unpacking on the device, under GLV
    the scalar split, the decomposition, the window sums, and the tail
    (Horner, one copy, the export)."""
    from msm_tpu_torch.models import common, cuzk
    from msm_tpu_torch.ops import glv

    cfg, st = plan.cfg, {}

    def mark(name, t0):
        torch.cuda.synchronize()
        st[name] = (time.perf_counter() - t0) * 1e3
        return time.perf_counter()

    t0 = time.perf_counter()
    plan._stage(0, words)
    t0 = mark("host_pack", t0)
    packed = plan._upload(0, slice(None))
    t0 = mark("upload", t0)
    st["upload_MiB"] = packed.numel() * packed.element_size() / 2**20
    sd = common.unpack_scalar_words(packed)
    t0 = mark("unpack", t0)
    if cfg.glv:
        split = glv.split_scalars_device(sd, cfg)
        t0 = mark("glv_split", t0)
        keys, signs = glv.decompose_halves(split, cfg.chunk_size, cfg.num_subtasks)
    else:
        keys, signs = cuzk.decompose_scalars(sd, cfg)
    t0 = mark("decompose", t0)
    ws = cuzk.window_sums_from_keys(plan.tables[0], keys, signs, cfg, plan.geom)
    t0 = mark("window_sums", t0)
    cuzk.msm_jpoints_from_ws([ws], cfg)
    mark("tail", t0)
    return st


def run_plan_checks(inputs, batch: int = 4, device="cuda") -> None:
    """The serving plan (msm_tpu_torch.plan) on the plain, compressed, GLV
    and GLV compressed configs at each size of ``inputs`` (run_msm_checks'
    points, scalars and oracle): build it (its stages printed), call it
    with ints and with u16 words [n, 16], three more word calls and a
    run_batch of ``batch`` distinct word sets, each against its oracle bit
    for bit, every call with the counters reset just before: a plan call
    launches the path's kernels but no convert. Then one line per config
    and size: the words call's wall median of 5 and the ints call's of 3,
    the words call by stage, one profiled words call (device busy, idle
    share, kernel ms), peak device memory of the word calls and of
    run_batch, run_batch's wall."""
    import msm_tpu_torch
    from msm_tpu_torch.models import common
    from msm_tpu_torch.ops._build import BUILD_ROOT
    from msm_tpu_torch.oracle.pyecc import Curve
    from msm_tpu_torch.params import BN254

    cv = Curve(BN254)
    for logn, (base, pts, ks, want) in inputs.items():
        n = 1 << logn
        t0 = time.perf_counter()
        words = common.ints_to_u16_array(ks)
        sets = batch_sets(base, n, batch, SEED + 20 + logn)
        print(f"plan 2^{logn}: words + {batch} batch sets and their oracles {time.perf_counter() - t0:.1f} s",
              flush=True)
        want_aff = cv.to_affine(want)
        for path in PLAN_PATHS:
            cfg, _ = msm_path(path, n, device)
            tag = f"plan 2^{logn} {path} (c={cfg.chunk_size} S={cfg.num_subtasks})"
            _reset_counts()
            t0 = time.perf_counter()
            plan = msm_tpu_torch.plan(pts, config=cfg, device=device)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            conv = _kernels()["convert_pack_glv" if cfg.glv else "convert_pack"][0]
            if conv.launches != 1:
                raise AssertionError(f"{tag}: the build launched the convert {conv.launches} times, not once")
            stages = plan_build_stages(pts, cfg, device)
            print(f"{tag}: build {build_s:.3f} s; stages_ms "
                  + ", ".join(f"{k}={v:.1f}" for k, v in stages.items()), flush=True)
            for label, scalars in (("ints", ks), ("words", words)):
                _reset_counts()
                got = plan(scalars)
                torch.cuda.synchronize()
                _counts_of(f"{tag} {label} call", f"plan_{path}")
                if got != want_aff:
                    raise AssertionError(f"{tag}: the {label} call differs from the oracle: {got}")
            for _ in range(3):
                if plan(words) != want_aff:
                    raise AssertionError(f"{tag}: a repeated words call differs from the oracle")
            _reset_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            got = plan.run_batch([w for w, _ in sets])
            batch_ms = (time.perf_counter() - t0) * 1e3
            batch_gib = torch.cuda.max_memory_allocated() / 2**30
            _counts_of(f"{tag} run_batch B={batch}", f"plan_{path}")
            for b, (g, (_, w)) in enumerate(zip(got, sets)):
                if not cv.eq(g, w):
                    raise AssertionError(f"{tag}: run_batch set {b} differs from its oracle")
            torch.cuda.reset_peak_memory_stats()
            words_ms, words_runs = _median_ms(lambda: plan(words), 5)
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            ints_ms, ints_runs = _median_ms(lambda: plan(ks), 3)
            st = plan_stage_times(plan, words)
            wall_ms, busy_ms, by_name = device_breakdown(
                lambda _pts, w: plan(w), None, words, BUILD_ROOT / f"trace_plan_2e{logn}_{path}.json")
            print(f"{tag}: bit-exact (ints, words x4, run_batch B={batch}); words wall_ms median of 5 = "
                  f"{words_ms:.2f} (runs {', '.join(f'{w:.2f}' for w in words_runs)}); ints wall_ms median of 3 = "
                  f"{ints_ms:.1f} (runs {', '.join(f'{w:.1f}' for w in ints_runs)}); run_batch B={batch} "
                  f"wall_ms={batch_ms:.2f} peak_mem_gib={batch_gib:.3f}; words peak_mem_gib={peak_gib:.3f}; "
                  "words stages_ms " + ", ".join(f"{k}={v:.2f}" for k, v in st.items()), flush=True)
            print(f"{tag}: profiled words call wall_ms={wall_ms:.2f} device_busy_ms={busy_ms:.2f} "
                  f"kernel_ms={busy_ms - by_name.get('memcpy', 0.0):.2f} idle_share={1 - busy_ms / wall_ms:.3f}; "
                  "device_ms " + ", ".join(f"{k}={v:.2f}" for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])),
                  flush=True)
            del plan


def check_batched(instances: int = 4, logn: int = 16, device="cuda") -> None:
    """compute_msm_batched over ``instances`` MSMs of 2^logn points on the
    plain config, counters reset just before: each result against the
    oracle MSM over all its points; K2 once per instance; the wall (first
    call, then a median of 3)."""
    from msm_tpu_torch.models.batched import compute_msm_batched
    from msm_tpu_torch.oracle import best_msm
    from msm_tpu_torch.oracle.pyecc import Curve
    from msm_tpu_torch.params import BN254

    cv = Curve(BN254)
    n = 1 << logn
    cfg, _ = msm_path("plain", n, device)
    t0 = time.perf_counter()
    inst = [sample_msm(n, seed=SEED + 30 + i)[1:] for i in range(instances)]
    wants = [best_msm(pts, ks) for pts, ks in inst]
    print(f"batched {instances} x 2^{logn}: inputs + oracles {time.perf_counter() - t0:.1f} s", flush=True)
    tag = f"batched {instances} x 2^{logn} plain (c={cfg.chunk_size} S={cfg.num_subtasks})"
    _reset_counts()
    t0 = time.perf_counter()
    got = compute_msm_batched(inst, cfg, device=device)
    first_ms = (time.perf_counter() - t0) * 1e3
    counts = _counts_of(tag, "batched")
    if counts["convert_pack"] != instances:
        raise AssertionError(f"{tag}: convert_pack launched {counts['convert_pack']} times, not {instances}")
    for i, (g, w) in enumerate(zip(got, wants)):
        if w.is_identity() or not cv.eq(g, w):
            raise AssertionError(f"{tag}: instance {i} differs from its oracle")
    wall_ms, runs = _median_ms(lambda: compute_msm_batched(inst, cfg, device=device), 3)
    print(f"{tag}: bit-exact; first call {first_ms:.1f} ms; wall_ms median of 3 = {wall_ms:.1f} "
          f"(runs {', '.join(f'{w:.1f}' for w in runs)})", flush=True)


def compare_uploads(ks, device="cuda") -> None:
    """One line: the plan's upload of packed scalar words (32 B a scalar)
    from its pinned buffer against a pageable torch.from_numpy(...).to() of
    the same bytes, and against the per-call path's 64 B a scalar (int32
    words, pageable); median of 5 each, each copy ended by a synchronize."""
    from msm_tpu_torch.models import common
    from msm_tpu_torch.params import DEFAULT_CONFIG

    pairs = common.pack_scalar_words(common.ints_to_u16_array(ks))
    pinned = common.staging_buffer(pairs.shape, device)
    pinned.numpy()[:] = pairs
    wide = common.pad_scalars_words(ks, DEFAULT_CONFIG, len(ks))
    cases = {"pinned": lambda: pinned.to(device, non_blocking=True),
             "pageable": lambda: torch.from_numpy(pairs).to(device),
             "pageable_int32_words": lambda: torch.from_numpy(wide).to(device)}
    mib = {"pinned": pairs.nbytes, "pageable": pairs.nbytes, "pageable_int32_words": wide.nbytes}
    parts = []
    for name, fn in cases.items():
        fn()
        med, runs = _median_ms(fn, 5)
        parts.append(f"{name} {mib[name] / 2**20:.0f} MiB {med:.3f} ms (runs {', '.join(f'{r:.3f}' for r in runs)})")
    if not torch.equal(cases["pinned"]().cpu(), torch.from_numpy(pairs)):
        raise AssertionError("the pinned upload differs from its source")
    print(f"uploads of 2^{len(ks).bit_length() - 1} scalars, median of 5: " + "; ".join(parts), flush=True)


def _in_process(main, argv: list[str], tag: str, path: str | None) -> str:
    """``main(argv)`` of the port's command line or bench in this process,
    its standard output captured, with every launch counter reset just
    before and, when ``path`` names one, the path's kernels required of it
    just after. Returns the output (one JSON value)."""
    buf = io.StringIO()
    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        main(argv)
    torch.cuda.synchronize()
    if path:
        _counts_of(tag, path)
    out = buf.getvalue().strip()
    print(f"{tag}: {time.perf_counter() - t0:.1f} s; {re.sub(r'\s+', ' ', out)}", flush=True)
    return out


def _as_module(module: str, argv: list[str], tag: str) -> str:
    """``python -m module argv`` in a process of its own, from the root of
    the checkout; it must exit 0. Returns its output's last line."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", module, *argv], cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"{tag}: exit {r.returncode}\n{r.stdout}\n{r.stderr[-4000:]}")
    last = r.stdout.strip().splitlines()[-1]
    print(f"{tag}: {time.perf_counter() - t0:.1f} s (own process); {last}", flush=True)
    return last


def run_cli_checks() -> None:
    """The port's command line (python -m msm_tpu_torch): verify --size 16
    on the plain, compressed, GLV and GLV compressed configs (the first in
    a process of its own, the others in this one, each reset and checked
    for its path's kernels), each bit-exact; msm --size 16 against cpu
    --size 16; profile --size 20, its report printed."""
    from msm_tpu_torch import cli

    for flags, path in (([], "plain"), (["--compress"], "compressed"), (["--glv"], "glv"),
                        (["--glv", "--compress"], "glv_compressed")):
        argv = ["verify", "--size", "16", *flags]
        tag = f"cli {' '.join(argv)}"
        line = _as_module("msm_tpu_torch", argv, tag) if not flags else _in_process(cli.main, argv, tag, path)
        if json.loads(line).get("bit_exact") is not True:
            raise AssertionError(f"{tag}: {line}")
    got = json.loads(_in_process(cli.main, ["msm", "--size", "16"], "cli msm --size 16", "plain"))
    want = json.loads(_in_process(cli.main, ["cpu", "--size", "16"], "cli cpu --size 16", None))
    if (got["x"], got["y"]) != (want["x"], want["y"]):
        raise AssertionError(f"cli msm --size 16 differs from cpu --size 16: {got} {want}")
    json.loads(_in_process(cli.main, ["profile", "--size", "20"], "cli profile --size 20", "plain"))


#: the bench runs of the bench phase: (arguments, the path its kernels take)
BENCH_RUNS = (
    (["--size", "20", "--verify"], "plain"),
    (["--size", "20", "--verify", "--compress"], "compressed"),
    (["--size", "20", "--verify", "--glv"], "glv"),
    (["--size", "20", "--verify", "--glv", "--compress"], "glv_compressed"),
    (["--plan", "4", "--size", "20", "--verify"], "plain"),
    (["--batched", "4", "--size", "16", "--verify"], "batched"),
    (["--auto", "--size", "16"], "auto"),
)


def run_bench_checks() -> None:
    """The port's bench (python -m msm_tpu_torch.bench) in each of
    BENCH_RUNS, in this process (the sharded phase's bench processes start
    it as a user does), each reset and checked for its path's kernels:
    every JSON line printed and each one verified against the oracle."""
    from msm_tpu_torch import bench

    for argv, path in BENCH_RUNS:
        tag = f"bench {' '.join(argv)}"
        line = _in_process(bench.main, argv, tag, path)
        if json.loads(line).get("verified") is not True:
            raise AssertionError(f"{tag}: not verified: {line}")


def run_chunked_checks(base, pts20, per_pass: dict, device="cuda") -> None:
    """The MSM above the one-pass cap: cuzk.CHUNK_MAX set to 2^20 and 2^21
    points (step 5's 2^20 points ``pts20`` twice: the same tiling) with
    fresh scalars, then the constant restored. run_gpu_msm on the plain,
    compressed, GLV and GLV compressed configs, compute_msm_naive, a plan
    (an ints and a words call, run_batch of 2) and the batched model (2
    instances), each with the counters reset just before, bit-exact against
    the folded oracle; each run's point-add launches less two passes'
    (``per_pass``: the 2^20 runs' counts) are its merges, one per instance."""
    import msm_tpu_torch
    from msm_tpu_torch import bench
    from msm_tpu_torch.models import cuzk
    from msm_tpu_torch.models.batched import compute_msm_batched
    from msm_tpu_torch.oracle.pyecc import Curve
    from msm_tpu_torch.params import BN254
    from msm_tpu_torch.utils.limbs import bytes_to_scalars

    cv = Curve(BN254)
    cap = len(pts20)
    n = 2 * cap
    t0 = time.perf_counter()
    pts = pts20 + pts20
    words = random_scalar_words(np.random.default_rng(SEED + 40), n)
    rolled = np.roll(words, 1, axis=0)
    ks, ks_rolled = (bytes_to_scalars(w.tobytes()) for w in (words, rolled))
    want, want_rolled = (bench.folded_oracle(base, w) for w in (words, rolled))
    print(f"chunked 2 x 2^{cap.bit_length() - 1}: inputs + oracles {time.perf_counter() - t0:.1f} s", flush=True)

    def check(tag, path, instances, fn, wants):
        _reset_counts()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts_of(tag, path)
        # a plan call and a batched instance run the plain path's passes
        merges = counts["point_add"] - instances * 2 * per_pass.get(path, per_pass["plain"])
        if merges != instances:
            raise AssertionError(f"{tag}: {merges} merge launches, not {instances}")
        for g, w in zip(got, wants):
            if not cv.eq(g, w):
                raise AssertionError(f"{tag}: differs from the folded oracle")
        print(f"{tag}: bit-exact; wall {wall:.3f} s; point-add merge launches {merges} "
              f"(of {counts['point_add']})", flush=True)

    saved = cuzk.CHUNK_MAX
    cuzk.CHUNK_MAX = cap
    try:
        for path in ("plain", "compressed", "naive", "glv", "glv_compressed"):
            cfg, run = msm_path(path, n, device)
            tag = f"chunked 2 x 2^{cap.bit_length() - 1} {path} (c={cfg.chunk_size} S={cfg.num_subtasks})"
            check(tag, path, 1, lambda: [cv.from_affine(*run(pts, ks))], [want])
        cfg, _ = msm_path("plain", n, device)
        _reset_counts()
        plan = msm_tpu_torch.plan(pts, config=cfg, device=device)
        if len(plan.tables) != 2 or _kernels()["convert_pack"][0].launches != 2:
            raise AssertionError("chunked plan: not one table and one convert per chunk")
        for label, scalars in (("ints", ks), ("words", words)):
            check(f"chunked plan {label} call", "plan_plain", 1, lambda: [plan.jpoint(scalars)], [want])
        check("chunked plan run_batch B=2", "plan_plain", 2, lambda: plan.run_batch([words, rolled]),
              [want, want_rolled])
        check("chunked batched 2 instances", "batched", 2,
              lambda: compute_msm_batched([(pts, ks), (pts, ks_rolled)], cfg, device=device), [want, want_rolled])
    finally:
        cuzk.CHUNK_MAX = saved


def largest_cap(peaks_gib: dict, logn: int, total_gib: float, share: float = 0.75) -> int:
    """The largest power of two n whose one-pass peak, scaled linearly
    from each config's peak at 2^logn, stays under ``share`` of the card's
    memory in every config."""
    k = logn
    while max(peaks_gib.values()) * 2 ** (k + 1 - logn) <= share * total_gib:
        k += 1
    return 1 << k


def one_pass_checks(base, logn: int, seed: int, scaled: dict | None = None, device="cuda") -> tuple[dict, dict]:
    """One pass at 2^logn points (step 5's bases tiled, their words
    uploaded; fresh scalar words) on the plain, compressed, naive, GLV and
    GLV compressed configs, each reset and checked for its path's kernels
    and bit-exact against the folded oracle, with its peak device memory
    (beside ``scaled``'s estimate, when given). Returns ({path: peak GiB},
    {path: point-add launches})."""
    from msm_tpu_torch import bench
    from msm_tpu_torch.models import common, cuzk, naive
    from msm_tpu_torch.models.geometry import pick_geometry
    from msm_tpu_torch.oracle.pyecc import Curve
    from msm_tpu_torch.params import BN254, pick_config

    cv = Curve(BN254)
    n = 1 << logn
    t0 = time.perf_counter()
    xw, yw = (np.tile(a, (n // len(base), 1)) for a in common.pad_points_words(base, pick_config(n), len(base)))
    words = random_scalar_words(np.random.default_rng(seed), n)
    want = bench.folded_oracle(base, words)
    xd, yd, sd = (torch.from_numpy(a).to(device) for a in (xw, yw, words.astype(np.int32)))
    print(f"one pass 2^{logn}: inputs + oracle {time.perf_counter() - t0:.1f} s", flush=True)
    peaks, adds = {}, {}
    for path in ("plain", "compressed", "naive", "glv", "glv_compressed"):
        cfg, _ = msm_path(path, n, device)
        geom = pick_geometry(n, cfg)
        tag = f"one pass 2^{logn} {path} (c={cfg.chunk_size} S={cfg.num_subtasks})"
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        if path == "naive":
            got = naive.naive_result(naive.naive_window_sums(common.prepare_points(cfg, xd, yd), sd, cfg, geom), cfg)
        else:
            got = common.std_ints_to_jpoint(*cuzk.cuzk_msm_point(xd, yd, sd, cfg, geom), cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peaks[path] = torch.cuda.max_memory_allocated() / 2**30
        adds[path] = _counts_of(tag, path)["point_add"]
        if not cv.eq(got, want):
            raise AssertionError(f"{tag}: differs from the folded oracle")
        est = f" (scaled from the smaller pass: {scaled[path]:.3f})" if scaled else ""
        print(f"{tag}: bit-exact; first call {wall:.3f} s; peak_mem_gib={peaks[path]:.3f}{est}", flush=True)
    del xd, yd, sd
    torch.cuda.empty_cache()
    return peaks, adds


def run_beyond_checks(base, logn: int = 22, device="cuda") -> None:
    """The sizes above the JAX package's 2^22 cap. One pass at 2^22 on the
    five configs (``one_pass_checks``): the peaks that set cuzk.CHUNK_MAX,
    which must not exceed the cap derived here. Then one pass at CHUNK_MAX
    itself on the five configs, each bit-exact, its peak printed beside the
    2^22 peak scaled up and held under 75% of the card. Then a plain MSM of
    2 x CHUNK_MAX points from host arrays, two passes at the real cap and
    one point-add merge, bit-exact. Then a plain plan over 2^23 points, run
    as one pass: its build time, a words call (np.uint16 [2^23, 16])
    bit-exact against the folded oracle, the words call's wall median of 3
    and its peak memory."""
    import msm_tpu_torch
    from msm_tpu_torch import bench
    from msm_tpu_torch.models import common, cuzk
    from msm_tpu_torch.models.geometry import pick_geometry
    from msm_tpu_torch.oracle.pyecc import Curve
    from msm_tpu_torch.params import BN254, pick_config

    cv = Curve(BN254)
    peaks, _ = one_pass_checks(base, logn, SEED + 50, device=device)
    total = torch.cuda.get_device_properties(0).total_memory / 2**30
    cap = largest_cap(peaks, logn, total)
    print(f"one-pass peak memory at 2^{logn} (GiB): " + ", ".join(f"{k}={v:.3f}" for k, v in peaks.items())
          + f"; card {total:.2f} GiB; the largest 2^k under 75% of it in every config: 2^{cap.bit_length() - 1}; "
          f"CHUNK_MAX = 2^{cuzk.CHUNK_MAX.bit_length() - 1}", flush=True)
    if cuzk.CHUNK_MAX > cap:
        raise AssertionError(f"CHUNK_MAX = {cuzk.CHUNK_MAX} exceeds the cap the card allows, {cap}")

    logc = cuzk.CHUNK_MAX.bit_length() - 1
    scale = 2 ** (logc - logn)
    peaks_c, adds_c = one_pass_checks(base, logc, SEED + 52, {k: v * scale for k, v in peaks.items()}, device)
    over = {k: v for k, v in peaks_c.items() if v > 0.75 * total}
    if over:
        raise AssertionError(f"one pass at CHUNK_MAX: peaks over 75% of the card: {over}")
    print(f"one-pass peak memory at CHUNK_MAX = 2^{logc} (GiB): "
          + ", ".join(f"{k}={v:.3f} (scaled {peaks[k] * scale:.3f})" for k, v in peaks_c.items())
          + f"; 75% of the card {0.75 * total:.2f}", flush=True)

    n = 2 * cuzk.CHUNK_MAX
    cfg = pick_config(n)
    tag = f"chunked 2 x 2^{logc} plain (c={cfg.chunk_size} S={cfg.num_subtasks})"
    t0 = time.perf_counter()
    xw, yw = (np.tile(a, (n // len(base), 1)) for a in common.pad_points_words(base, cfg, len(base)))
    words = random_scalar_words(np.random.default_rng(SEED + 53), n)
    want = bench.folded_oracle(base, words)
    sw = words.astype(np.int32)
    print(f"{tag}: inputs + oracle {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    got = common.std_ints_to_jpoint(*cuzk.cuzk_msm_point(
        xw, yw, sw, cfg, pick_geometry(cuzk.CHUNK_MAX, cfg), device=device), cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    merges = _counts_of(tag, "plain")["point_add"] - 2 * adds_c["plain"]
    if merges != 1:
        raise AssertionError(f"{tag}: {merges} merge launches, not 1")
    if not cv.eq(got, want):
        raise AssertionError(f"{tag}: differs from the folded oracle")
    print(f"{tag}: bit-exact from host arrays; wall {wall:.3f} s (uploads included); point-add merge "
          f"launches {merges}; peak_mem_gib={torch.cuda.max_memory_allocated() / 2**30:.3f}", flush=True)
    del xw, yw, sw, words
    torch.cuda.empty_cache()

    n = 2 << logn
    cfg = pick_config(n)
    tag = f"plan 2^{logn + 1} plain one pass (c={cfg.chunk_size} S={cfg.num_subtasks})"
    t0 = time.perf_counter()
    pts = [base[i % len(base)] for i in range(n)]
    words = random_scalar_words(np.random.default_rng(SEED + 51), n)
    want = bench.folded_oracle(base, words)
    print(f"{tag}: inputs + oracle {time.perf_counter() - t0:.1f} s", flush=True)
    _reset_counts()
    t0 = time.perf_counter()
    plan = msm_tpu_torch.plan(pts, config=cfg, device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if len(plan.tables) != 1:
        raise AssertionError(f"{tag}: {len(plan.tables)} tables, not one pass")
    _reset_counts()
    if not cv.eq(plan.jpoint(words), want):
        raise AssertionError(f"{tag}: the words call differs from the folded oracle")
    _counts_of(f"{tag} words call", "plan_plain")
    torch.cuda.reset_peak_memory_stats()
    med, runs = _median_ms(lambda: plan.jpoint(words), 3)
    print(f"{tag}: bit-exact; build {build_s:.2f} s; words call wall_ms median of 3 = {med:.2f} "
          f"(runs {', '.join(f'{r:.2f}' for r in runs)}); peak_mem_gib={torch.cuda.max_memory_allocated() / 2**30:.3f}",
          flush=True)


#: the six curves besides BN254, each on the plain path (the curves phase)
CURVE_NAMES = ("bls12_381", "bls12_377", "grumpkin", "pallas", "vesta", "secp256k1")
#: the limb widths of the kernels (ops/_build.WIDTHS): the phases above
#: run the 13-bit library, the width-12 and narrow-widths phases the
#: narrow one; each width's random streams start at their own offset
WIDTH_SEED = {13: 0, 12: 1000, 11: 2000, 10: 3000, 9: 4000, 8: 5000}


def _curve_index(curve: str) -> int:
    """A curve's index in the curves phase's seeds: CURVE_NAMES', BN254
    after them."""
    return CURVE_NAMES.index(curve) if curve in CURVE_NAMES else len(CURVE_NAMES)


def _w(word_size: int) -> str:
    """A label's width suffix: none at 13-bit limbs, " w<width>" at the
    narrow library's widths."""
    return "" if word_size == 13 else f" w{word_size}"

#: the plain path's kernels, each instantiated for every curve (kernel 3,
#: the histogram, has no field arithmetic)
CURVE_KERNELS = ("point_add", "convert_pack", "scan_rows", "row_offsets", "point_total", "horner")
#: the curves also run at 2^20 through a plan's words call (the others at
#: 2^16 only); each curve's kernels are held at its largest MSM's shapes
CURVES_AT_2E20 = ("bls12_381",)
#: the configs each curve also runs besides the plain path (PR 15), through
#: msm_path's configs
CURVE_CONFIGS = ("compressed", "glv", "glv_compressed")
#: the generic kernels that only these configs run, each with the config
#: whose 2^16 run_gpu_msm gives its launches in the kernel table
CONFIG_KERNELS = {"mont_pow": "compressed", "pair_suffix": "compressed", "emit_scan": "compressed",
                  "convert_pack_glv": "glv", "scan_rows_glv": "glv", "pair_suffix_glv": "glv_compressed",
                  "emit_scan_glv": "glv_compressed"}
#: the curves whose three configs also run at 2^20 (a plan's words call)
CONFIGS_AT_2E20 = ("bls12_381",)
#: a curve's MSM runs its config's kernels (a compressed path K9, K12 and
#: K13, a GLV path only the *_glv modes), its plan calls all but the convert
for _c in ("bn254",) + CURVE_NAMES:
    for _p in ("plain",) + CURVE_CONFIGS:
        for _ws in WIDTH_SEED:
            _tag = f"curve_{_c}" + ("" if _p == "plain" else f"_{_p}") + _w(_ws).replace(" ", "_")
            PATHS[_tag], EXCLUDED[_tag] = PATHS[_p], EXCLUDED[_p]
            PATHS[f"plan_{_tag}"], EXCLUDED[f"plan_{_tag}"] = PATHS[f"plan_{_p}"], EXCLUDED[f"plan_{_p}"]
#: the kernels generic over the field, by wrapper: (their kernels, BN254's
#: object file, the suffix of each other curve's translation unit): the
#: plain kernels and the GLV modes of the convert and the scan in
#: csrc/curve_<name>.cu, the pair kernels, BPR phase 1 and the scaled
#: convert in csrc/curve_<name>_pairs.cu
CURVE_INSTANCES = {
    "point_add": (("k_point_add", "k_point_add_lanes"), "point_add.o", ""),
    "convert_pack": (("k_convert",), "convert.o", ""),
    "scan_rows": (("k_scan",), "scan.o", ""),
    "row_offsets": (TRACE_KERNELS["row_offsets"], "prefix.o", ""),
    "point_total": (TRACE_KERNELS["point_total"], "point_total.o", ""),
    "horner": (("k_horner",), "horner.o", ""),
    "convert_pack_glv": (("k_convert_glv",), "convert.o", ""),
    "scan_rows_glv": (("k_scan_glv",), "scan.o", ""),
    "mont_pow": (("k_mont_pow",), "inv.o", "_pairs"),
    "pair_suffix": (("k_pair_suffix",), "compress.o", "_pairs"),
    "pair_suffix_glv": (("k_pair_suffix_glv",), "compress.o", "_pairs"),
    "emit_scan": (("k_emit_scan",), "compress.o", "_pairs"),
    "emit_scan_glv": (("k_emit_scan_glv",), "compress.o", "_pairs"),
    "pair_forward": (("k_pair_forward",), "compress.o", "_pairs"),
    "pair_forward_glv": (("k_pair_forward_glv",), "compress.o", "_pairs"),
    "pair_backward": (("k_pair_backward",), "compress.o", "_pairs"),
    "pair_backward_glv": (("k_pair_backward_glv",), "compress.o", "_pairs"),
    "bpr_phase1": (("k_bpr_phase1",), "bpr.o", "_pairs"),
    "convert_pack_scaled": (tuple(f"k_convert_scaled<{i}>" for i in range(3)), "convert.o", "_pairs"),
}
#: each other curve's instances off every served config's path
#: (csrc/curve_<name>_pairs.cu), each with the path whose run on the curve
#: gives its launches: compress_pairs without and with GLV, the blocked
#: stage 4, the scaled convert's five modes
OFFPATH_KERNELS = {"pair_forward": "pairs", "pair_backward": "pairs", "pair_forward_glv": "pairs_glv",
                   "pair_backward_glv": "pairs_glv", "bpr_phase1": "blocked", "convert_pack_scaled": "convert_scaled"}
#: every kernel instance's ptxas report by (curve, kernel name, limb
#: width), filled by report_plain_builds for the kernels line
PTXAS: dict = {}


def _ptxas_fields(curve: str, name: str, word_size: int = 13) -> dict:
    """A wrapper's kernel's registers and spill bytes on a curve at a limb
    width for the kernels line (PTXAS; the scaled convert's two-table
    layout, the first kernel of a wrapper that runs several); none for the
    histogram."""
    if name not in CURVE_INSTANCES:
        return {}
    kernel = "k_convert_scaled<1>" if name == "convert_pack_scaled" else CURVE_INSTANCES[name][0][0]
    rep = PTXAS[(curve, kernel, word_size)]
    return {"registers": rep["registers"], "spill_stores": rep["spill_stores"], "spill_loads": rep["spill_loads"]}


@functools.lru_cache(maxsize=None)
def _curve_affine(name: str) -> tuple:
    """A curve's 64 affine sample points (seed SEED) of the kernel checks,
    made once: every width's checks of the curve share them."""
    from msm_tpu_torch.oracle.pyecc import Curve

    cv = Curve(_curve_spec(name))
    return tuple(cv.to_affine(p) for p in cv.sample_points(64, seed=SEED))


def _curve_spec(name: str):
    from msm_tpu_torch.params import CURVES

    return CURVES[name]


def _field_of(name: str) -> str:
    """The traits type of csrc/fields.cuh for a curve name."""
    return {"bn254": "FpBn254", "bls12_377": "FpBls12_377", "pallas": "FpPallas", "bls12_381": "FpBls12_381",
            "secp256k1": "FpSecp256k1", "grumpkin": "FpGrumpkin", "vesta": "FpVesta"}[name]


def _kernel_objects(lib_dir: Path) -> list[Path]:
    """The object files of a library's generic kernels (CURVE_INSTANCES'
    BN254 units and every other curve's two)."""
    return ([lib_dir / obj for _kernels, obj, _unit in CURVE_INSTANCES.values()]
            + [lib_dir / f"curve_{curve}{unit}.o" for curve in CURVE_NAMES for unit in ("", "_pairs")])


def report_plain_builds(so, word_size: int = 13, widths: tuple = ()) -> dict:
    """One line per kernel and curve (CURVE_INSTANCES: every kernel is
    generic over the field) of the library ``so`` that serves limb width
    ``word_size`` (its own build log and objects): ptxas registers, frame
    and spills and the SASS size; raises when a kernel makes an out-of-line
    call (the word core inlines every formula, the row offsets' included).
    Returns and keeps in PTXAS {(curve, kernel, width): ptxas report} for
    the kernel table, for ``word_size`` and every width of ``widths`` (the
    narrow library: one instance serves its widths 8 to 12)."""
    log = (so.parent / "build.log").read_text()
    reports = {}
    _prefetch_sass(_kernel_objects(so.parent))
    for curve in ("bn254",) + CURVE_NAMES:
        field = _field_of(curve)
        for wrapper, (kernels, obj, unit) in CURVE_INSTANCES.items():
            path = so.parent / (obj if curve == "bn254" else f"curve_{curve}{unit}.o")
            for kernel in kernels:
                rep = _ptxas(log, kernel, field)
                n, calls = _sass_calls(path, kernel, field)
                reports[(curve, kernel)] = rep
                for w in {word_size, *widths}:
                    PTXAS[(curve, kernel, w)] = rep
                print(f"ptxas {curve}{' narrow' if widths else _w(word_size)} {kernel}: registers={rep['registers']} frame={rep['frame']} B "
                      f"spill_stores={rep['spill_stores']} B spill_loads={rep['spill_loads']} B; "
                      f"SASS {n} instructions, {calls} CALL", flush=True)
                if calls:
                    raise AssertionError(f"{kernel}<{field}>{_w(word_size)} makes {calls} out-of-line calls")
    return reports


def check_curve_kernels(kern, curve: str, logn: int | None, clock_hz: float, dev, word_size: int = 13) -> dict:
    """The plain path's six kernels of one curve against their twins on the
    card, on a random stream of the curve's own: at a small shape (chunk 8,
    n 2048, R 512, C 4, one subtask, 4 windows) when ``logn`` is None, else
    at the shapes the curve's 2^logn MSM gives them (pick_config(2^logn,
    curve) and models/geometry.py's rule): the convert over n points, the
    scan over G subtasks of C = n / R steps on R lanes and the row offsets
    over their G x R lane totals, the point add over the boundary prefixes'
    G x NB, the point total over S windows of NB - 1 points, the Horner
    ladder over S windows at chunk c (2^20: c 16, R 16384, C 64, G 4; 2^16:
    c 13, R 8192, C 8, G 4) on the 12-word curves and BN254 (the other
    8-word curves share BN254's body, held at its 2^20 and 2^16 shapes:
    only their small-shape ladder runs, the large one's twin taking ~6 s).
    The scan and the convert on random canonical
    tables and coordinates (the convert also on words anywhere below
    2^(32 D)), the row offsets and the point total on real curve points
    (they reassociate). At ``word_size``-bit limbs (the instances of that
    width's library). Returns {kernel: result} as _check_case gives it."""
    from msm_tpu_torch.models.geometry import pick_geometry
    from msm_tpu_torch.ops.cuda_convert import coord_u16, pack_canonical
    from msm_tpu_torch.ops.field import get_field_ctx
    from msm_tpu_torch.params import MsmConfig, coord_words, pick_config

    spec = _curve_spec(curve)
    small = logn is None
    n = 2048 if small else 1 << logn
    cfg = MsmConfig(curve=spec, chunk_size=8) if small else pick_config(n, spec)
    cfg = dataclasses.replace(cfg, word_size=word_size)
    f, L = get_field_ctx(cfg), cfg.num_words
    rng = np.random.default_rng(SEED + 100 + _curve_index(curve) + (0 if small else 10) + WIDTH_SEED[word_size])
    aff = list(_curve_affine(curve))
    base = torch.stack([torch.from_numpy(_mont(v, cfg)) for v in zip(*aff)]).to(dev)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    NB = cfg.num_buckets
    if small:
        R, G, S = 512, 1, 4
    else:
        geo = pick_geometry(n, cfg)
        R, G, S = geo.num_rows, min(geo.subtask_batch, cfg.num_subtasks), cfg.num_subtasks
    C = n // R
    B = 512 if small else G * NB
    pa = [_rand_fe(rng, (B,), cfg) for _ in range(6)]
    pa[1][: B // 8] *= -1
    wu = coord_u16(cfg)
    words = _coord_words(rng, n, cfg.curve.modulus, wu)
    anywhere = _coord_words(rng, n // 8, None, wu)
    words = [np.concatenate([w, a]) for w, a in zip(words, anywhere)]
    tab = torch.cat([pack_canonical(torch.from_numpy(_rand_fe(rng, (n,), cfg)), cfg) for _ in range(2)], dim=-1)
    perm = np.stack([rng.permutation(n).reshape(R, C).T for _ in range(G)]).astype(np.int32)
    flags = rng.integers(0, 2, size=perm.shape, dtype=np.int32)
    rows = _curve_points(rng, (G, R), cfg, base, dev)
    N = 512 if small else NB - 1
    cases = {
        "point_add": ([cfg, *map(t, pa)], False, 5),
        "convert_pack": ([cfg, *map(t, words)], False, 5),
        "scan_rows": ([cfg, tab.to(dev), t(perm), t(flags)], False, 3),
        "row_offsets": ([cfg, *(a.transpose(1, 2).contiguous() for a in rows)], True, 3),
        "point_total": ([cfg, *_curve_points(rng, (S, N), cfg, base, dev)], True, 3),
    }
    if small or coord_words(cfg) == 12 or curve == "bn254":
        cases["horner"] = ([cfg, *(t(_rand_fe(rng, (S,), cfg)) for _ in range(3)), 4 if small else cfg.chunk_size],
                           False, 3)
    label = f"{curve}{_w(word_size)} {'small' if small else f'2^{logn}'}"
    return {name: _check_case(kern, f, L, name, label, args, as_points, reps, clock_hz)
            for name, (args, as_points, reps) in cases.items()}


def check_curve_config_kernels(kern, curve: str, logn: int | None, clock_hz: float, dev,
                               word_size: int = 13) -> dict:
    """The seven instances the compressed and GLV configs add for one curve
    (CONFIG_KERNELS: the Fermat inversion, the suffix products and the
    emission + scan, the last two in both modes, and the GLV modes of the
    convert and the scan) against their twins on the card, on a random
    stream of the curve's own: at a small shape (chunk 8; the pair kernels
    G2 C8 R64) when ``logn`` is None, else at the shapes the curve's 2^logn
    MSMs on the three configs give them (msm_path's configs, models/
    geometry.py's rule: the compressed launch's G x C x R and its G x R
    Fermat lanes, the GLV compressed launch's, the GLV scan's). The pair
    kernels run over a table of 64 real points of the curve (the GLV modes
    over 32 points and their phi images) with planted doubling, infinity
    and, under GLV, equal-x-across-halves pairs (_pair_stream,
    _glv_pair_stream); the Fermat lanes with one, p - 1, zero and a negated
    value planted; the convert on coordinates below p and anywhere below
    2^(32 D); the GLV scan on a random canonical table. At the MSM shapes
    the kernels run the whole launch and the twins of the scan, the Fermat
    inversion and the pair kernels 256 of its chains, the first and last 64
    lanes of its first and last subtask (chains share no state there;
    chain_subset), on the CPU, and the kernels' outputs there are compared
    exactly. At ``word_size``-bit limbs. Returns {kernel: result} as
    _check_case gives it."""
    from msm_tpu_torch.models.geometry import pick_geometry
    from msm_tpu_torch.ops.cuda_convert import coord_u16, pack_canonical
    from msm_tpu_torch.ops.field import get_field_ctx
    from msm_tpu_torch.params import MsmConfig

    spec = _curve_spec(curve)
    small = logn is None
    n = 2048 if small else 1 << logn
    rng = np.random.default_rng(SEED + 200 + _curve_index(curve) + (0 if small else 10) + WIDTH_SEED[word_size])
    aff = list(_curve_affine(curve))
    base_cfg = MsmConfig(curve=spec, word_size=word_size)
    f, L = get_field_ctx(base_cfg), base_cfg.num_words
    base = torch.stack([torch.from_numpy(_mont(v, base_cfg)) for v in zip(*aff)]).to(dev)
    table = torch.cat([pack_canonical(base[i], base_cfg) for i in range(2)], dim=-1)
    glv_table = _glv_table(aff[:32], base_cfg).to(dev)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def config(path):
        if small:
            return MsmConfig(curve=spec, chunk_size=8, compress=path != "glv", glv=path != "compressed",
                             word_size=word_size)
        return msm_path(path, n, "cuda", spec, word_size)[0]

    label = f"{curve}{_w(word_size)} {'small' if small else f'2^{logn}'}"
    out = {}

    def check(name, args, reps, shape=""):
        sub = None if small else chain_subset(name, args)
        out[name] = _check_case(kern, f, L, name, f"{label}{shape}", args, False, reps, clock_hz, subset=sub)

    cc, gc, gcc = config("compressed"), config("glv"), config("glv_compressed")
    G, C, R = (2, 8, 64) if small else _compressed_shape(n, cc)
    check("mont_pow", [cc, t(_pow_lanes(rng, G, R, cc)), spec.modulus - 2], 3, f" {G} x {R} lanes")
    pair_in = [cc, table, *map(t, _pair_stream(rng, G, C, R, table.shape[0]))]
    check("pair_suffix", pair_in, 3, f" G{G} C{C} R{R}")
    check("emit_scan", _emit_scan_args(kern, pair_in), 3, f" G{G} C{C} R{R}")
    G, C, R = (2, 8, 64) if small else _compressed_shape(n, gcc)
    glv_in = [gcc, glv_table, *map(t, _glv_pair_stream(rng, G, C, R, glv_table.shape[0]))]
    check("pair_suffix_glv", glv_in, 3, f" G{G} C{C} R{R}")
    check("emit_scan_glv", _emit_scan_args(kern, glv_in), 3, f" G{G} C{C} R{R}")
    wu = coord_u16(gc)
    words = [np.concatenate([w, a]) for w, a in zip(_coord_words(rng, n, spec.modulus, wu),
                                                     _coord_words(rng, n // 8, None, wu))]
    out["convert_pack_glv"] = _check_case(kern, f, L, "convert_pack_glv", label, [gc, *map(t, words)], False, 5,
                                          clock_hz)
    if small:
        G, R = 2, 512
    else:
        geo = pick_geometry(n, gc)
        G, R = min(geo.subtask_batch, gc.num_subtasks), geo.num_rows
    check("scan_rows_glv", [gc, *_glv_scan_inputs(rng, n, G, R, gc, dev)], 3, f" G{G} C{2 * n // R} R{R}")
    return out


def check_curve_offpath_kernels(kern, curve: str, logn: int | None, clock_hz: float, dev,
                                word_size: int = 13) -> dict:
    """One curve's six instances off the served paths (OFFPATH_KERNELS) against
    their twins on the card, on a random stream of the curve's own: the
    forward products and the backward emission (kernels 10 and 11) in both
    modes at the shapes of the curve's 2^logn compressed and GLV compressed
    MSMs (models/geometry.py's rule) over the tables of
    check_curve_config_kernels, the kernel running the whole launch and its
    twin 256 of its chains on the CPU (chain_subset); BPR phase 1 at the
    blocked stage 4's shape of the curve's 2^16 plain MSM (pick_config:
    every window's body buckets over bpr_threads lanes; also at 2^20 when
    logn is 20), with planted rows (_bpr_buckets); the scaled convert in
    its five modes (_scaled_modes) on the 2^16 MSM's coordinates below p
    and n / 8 anywhere below 2^(32 D). When ``logn`` is None all at small
    shapes (the pair kernels G2 C8 R64, BPR phase 1 G1 T16 Bl16, the
    convert 2048 + 256 points). At ``word_size``-bit limbs. Returns
    {kernel: result} as _check_case gives it, from the largest shape."""
    from msm_tpu_torch.models.geometry import pick_geometry
    from msm_tpu_torch.ops.cuda_convert import coord_u16, pack_canonical
    from msm_tpu_torch.ops.field import get_field_ctx
    from msm_tpu_torch.params import MsmConfig, pick_config

    spec = _curve_spec(curve)
    small = logn is None
    n = 2048 if small else 1 << logn
    rng = np.random.default_rng(SEED + 300 + _curve_index(curve) + WIDTH_SEED[word_size])
    aff = list(_curve_affine(curve))
    base_cfg = MsmConfig(curve=spec, word_size=word_size)
    f, L = get_field_ctx(base_cfg), base_cfg.num_words
    base = torch.stack([torch.from_numpy(_mont(v, base_cfg)) for v in zip(*aff)]).to(dev)
    table = torch.cat([pack_canonical(base[i], base_cfg) for i in range(2)], dim=-1)
    glv_table = _glv_table(aff[:32], base_cfg).to(dev)
    out = {}
    size = "small" if small else f"2^{logn}"

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def check(name, args, label, subset):
        out[name] = _check_case(kern, f, L, name, f"{curve}{_w(word_size)} {label}", args, False, 3, clock_hz,
                                subset=chain_subset(name, args) if subset else None)

    for path, stream, tab in (("compressed", _pair_stream, table), ("glv_compressed", _glv_pair_stream, glv_table)):
        cfg = msm_path(path, n, "cuda", spec, word_size)[0]
        G, C, R = (2, 8, 64) if small else _compressed_shape(n, cfg)
        pair_in = [cfg, tab, *map(t, stream(rng, G, C, R, tab.shape[0]))]
        mode = "_glv" if cfg.glv else ""
        check(f"pair_forward{mode}", pair_in, f"{size} G{G} C{C} R{R}", not small)
        check(f"pair_backward{mode}", _backward_args(kern, pair_in), f"{size} G{G} C{C} R{R}", not small)
    for bl_logn in () if small else (16, 20) if logn == 20 else (16,):
        cfg = dataclasses.replace(pick_config(1 << bl_logn, spec), word_size=word_size)
        T = pick_geometry(1 << bl_logn, cfg).bpr_threads
        G, Bl = cfg.num_subtasks, (cfg.num_buckets - 1) // T
        check("bpr_phase1", [cfg, *map(t, _bpr_buckets(rng, (G, Bl, T), cfg))], f"2^{bl_logn} G{G} T{T} Bl{Bl}",
              False)
    if small:
        check("bpr_phase1", [base_cfg, *map(t, _bpr_buckets(rng, (1, 16, 16), base_cfg))], "small G1 T16 Bl16",
              False)
    wu, m = coord_u16(base_cfg), 2048 if small else 1 << 16
    words = [t(np.concatenate([w, a])) for w, a in zip(_coord_words(rng, m, spec.modulus, wu),
                                                        _coord_words(rng, m // 8, None, wu))]
    scaled = {}
    for label, xs, xs2, triple in _scaled_modes(base_cfg):
        check("convert_pack_scaled", [base_cfg, *words, xs, xs2, triple],
              f"{'small' if small else '2^16'} {label}", False)
        scaled[label] = out["convert_pack_scaled"]
    out["convert_pack_scaled"] = scaled["dual"]
    return out


def run_curve_offpath_paths(curve: str, pts, ks, want, device="cuda", word_size: int = 13) -> dict:
    """The paths that run one curve's OFFPATH_KERNELS, each with the
    counters reset just before and its kernels required just after:
    compress_pairs without and with GLV (check_pairs: every pair sum and
    flag against the oracle), the scaled convert's five modes
    (run_convert_scaled), the blocked stage 4 (check_blocked) and the naive
    model (compute_msm_naive, 8-bit unsigned windows) on the curve's 2^16
    MSM, both bit-exact against its folded oracle; at ``word_size``-bit
    limbs. Returns {path: launch counts}."""
    from msm_tpu_torch.oracle.pyecc import Curve

    spec = _curve_spec(curve)
    counts = {"pairs": check_pairs(device=device, curve=spec, word_size=word_size),
              "pairs_glv": check_pairs(True, device, spec, word_size),
              "convert_scaled": run_convert_scaled(device, spec, 16, word_size)}
    counts["blocked"] = check_blocked(pts, ks, want, device, spec, word_size)
    cfg, run = msm_path("naive", len(pts), device, spec, word_size)
    tag = (f"curve {curve}{_w(word_size)} 2^{len(pts).bit_length() - 1} naive "
           f"(c={cfg.chunk_size} S={cfg.num_subtasks})")
    _reset_counts()
    t0 = time.perf_counter()
    got = run(pts, ks)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts["naive"] = _counts_of(tag, "naive")
    if got != Curve(spec).to_affine(want):
        raise AssertionError(f"{tag} differs from the oracle: {got}")
    med, runs = _median_ms(lambda: run(pts, ks), 3)
    print(f"{tag}: bit-exact; first call {first:.3f} s; wall_ms median of 3 = {med:.2f} (runs "
          f"{', '.join(f'{r:.2f}' for r in runs)}); point_add launches {counts['naive']['point_add']}", flush=True)
    return counts


#: the subgroup checks (cofactor > 1): (curve, log2 n)
SUBGROUP_CHECKS = (("bls12_381", 16), ("bls12_377", 16))


def check_subgroup(curve: str, pts, ks, words, want, device="cuda", word_size: int = 13) -> None:
    """validate=True on a curve of cofactor > 1 through run_gpu_msm and a
    plan (pick_config's config): each passes on the MSM's points (the
    result, or the plan's words call, bit-exact against the folded
    oracle), and rejects the same points with the curve's smallest-x point
    outside the order-r subgroup planted at index n/3 + 1 with ValueError
    naming that index. One line per entry with the seconds and the point
    add (K1) launches of the pass (validation and MSM) and of the reject
    (validation alone: one ladder of K1 launches over the padded points).
    At ``word_size``-bit limbs."""
    import msm_tpu_torch
    from msm_tpu_torch.ops.cuda_curve import point_add
    from msm_tpu_torch.oracle.pyecc import Curve
    from msm_tpu_torch.params import pick_config

    spec = _curve_spec(curve)
    cv = Curve(spec)
    n = len(pts)
    cfg = dataclasses.replace(pick_config(n, spec), word_size=word_size)
    needle, at = cv.first_point_outside_subgroup(), n // 3 + 1
    bad = list(pts)
    bad[at] = needle
    runs = {"run_gpu_msm": lambda p: msm_tpu_torch.run_gpu_msm(p, ks, config=cfg, validate=True, device=device),
            "plan": lambda p: msm_tpu_torch.plan(p, config=cfg, validate=True, device=device)}
    for entry, run in runs.items():
        tag = f"subgroup {curve}{_w(word_size)} 2^{n.bit_length() - 1} {entry}(validate=True)"
        point_add.launches = 0
        t0 = time.perf_counter()
        got = run(pts)
        got = cv.to_affine(got.jpoint(words)) if entry == "plan" else got
        torch.cuda.synchronize()
        pass_s, pass_k1 = time.perf_counter() - t0, point_add.launches
        if got != cv.to_affine(want):
            raise AssertionError(f"{tag}: differs from the oracle: {got}")
        point_add.launches = 0
        t0 = time.perf_counter()
        try:
            run(bad)
        except ValueError as e:
            if not str(e).startswith(f"point {at} is outside the prime-order subgroup (cofactor {spec.cofactor})"):
                raise AssertionError(f"{tag}: the needle at {at} raised {e!r}") from e
        else:
            raise AssertionError(f"{tag}: the needle at {at} passed")
        torch.cuda.synchronize()
        print(f"{tag}: subgroup points pass, bit-exact: {pass_s:.3f} s, {pass_k1} K1 launches; the needle "
              f"x={needle[0]} at {at} rejected: {time.perf_counter() - t0:.3f} s, {point_add.launches} K1 launches",
              flush=True)


def sample_curve_msm(curve: str, n: int, seed: int, base=None):
    """(bases, points, scalar words [n, 16]) of a curve's MSM: 1024 random
    points (``base`` when given) tiled to n, uniform scalars below the
    order as u16 words."""
    from msm_tpu_torch.oracle.pyecc import Curve

    spec = _curve_spec(curve)
    if base is None:
        cv = Curve(spec)
        base = [cv.to_affine(p) for p in cv.sample_points(min(n, 1024), seed=seed)]
    rng = np.random.default_rng(seed + 1)
    words = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.uint16)
    words[:, 15] = rng.integers(0, spec.order >> 240, size=n)
    return base, [base[i % len(base)] for i in range(n)], words


#: each curve's MSM inputs and folded oracle by (curve, log2 n), kept by
#: run_curve_msms for the narrow library's phases: (bases, points, scalar words,
#: oracle JPoint)
CURVE_INPUTS: dict = {}


def run_curve_msms(device="cuda") -> dict:
    """Each of the six curves on the four configs (the plain one and
    CURVE_CONFIGS) through the entry points a user calls, one curve's
    inputs and folded oracle shared by its configs (run_curve_config): at
    2^16 every config, at 2^20 the plain one for CURVES_AT_2E20 and every
    config for CONFIGS_AT_2E20; at 2^16 also the paths of OFFPATH_KERNELS
    and the naive model (run_curve_offpath_paths), and validate=True where
    SUBGROUP_CHECKS names the curve and size (check_subgroup); the stage
    split and the profile (run_curve_config's detail) for CONFIGS_AT_2E20
    only. Returns {(curve, config or path): launch counts of its 2^16
    run}."""
    from msm_tpu_torch import bench

    counts = {}
    for curve in CURVE_NAMES:
        spec = _curve_spec(curve)
        base = None
        for logn in (16, 20) if curve in CURVES_AT_2E20 else (16,):
            t0 = time.perf_counter()
            base, pts, words = sample_curve_msm(curve, 1 << logn, SEED + 60 + logn, base)
            want = bench.folded_oracle(base, words, spec)
            CURVE_INPUTS[(curve, logn)] = (base, pts, words, want)
            ks = [int.from_bytes(w.tobytes(), "little") for w in words] if logn == 16 else None
            print(f"curve {curve} 2^{logn}: inputs + oracle {time.perf_counter() - t0:.1f} s", flush=True)
            configs = CURVE_CONFIGS if logn == 16 or curve in CONFIGS_AT_2E20 else ()
            for path in ("plain",) + configs:
                c, _ = run_curve_config(curve, path, logn, pts, ks, words, want, device,
                                        detail=curve in CONFIGS_AT_2E20)
                if c is not None:
                    counts[(curve, path)] = c
            if logn == 16:
                for path, c in run_curve_offpath_paths(curve, pts, ks, want, device).items():
                    counts[(curve, path)] = c
            if (curve, logn) in SUBGROUP_CHECKS:
                ints = ks or [int.from_bytes(w.tobytes(), "little") for w in words]
                check_subgroup(curve, pts, ints, words, want, device)
    return counts


def run_curve_config(curve: str, path: str, logn: int, pts, ks, words, want, device="cuda",
                     word_size: int = 13, detail: bool = True) -> tuple[dict | None, float]:
    """One curve's MSM on one config (msm_path's, at ``word_size``-bit
    limbs) on the inputs and folded oracle of run_curve_msms (the
    pure-Python one: the native oracle is BN254's): run_gpu_msm on the ints
    (when ``ks`` is given) and a plan's words call, each with the counters
    reset just before and its path's kernels required just after (paths
    curve_<name>[_<config>][_w<width>], plan_curve_<name>[_<config>][_w<width>]),
    both bit-exact. One line per run: the wall median (run_gpu_msm of 3,
    words call of 5), and with ``detail`` the stages and peak memory, and a
    profiled words call's device busy time, kernel ms and idle share.
    Returns (the run_gpu_msm's launch counts or None without ``ks``, the
    words call's median ms)."""
    import msm_tpu_torch
    from msm_tpu_torch.ops._build import BUILD_ROOT
    from msm_tpu_torch.oracle.pyecc import Curve

    spec = _curve_spec(curve)
    cv = Curve(spec)
    cfg, run = msm_path(path, 1 << logn, device, spec, word_size)
    name = f"curve_{curve}" + ("" if path == "plain" else f"_{path}") + _w(word_size).replace(" ", "_")
    tag = f"curve {curve}{_w(word_size)} 2^{logn} {path} (c={cfg.chunk_size} S={cfg.num_subtasks} L={cfg.num_words})"
    counts = None
    if ks is not None:
        _reset_counts()
        t0 = time.perf_counter()
        got = run(pts, ks)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        counts = _counts_of(f"{tag} run_gpu_msm", name)
        if got != cv.to_affine(want):
            raise AssertionError(f"{tag}: run_gpu_msm differs from the oracle: {got}")
        if not detail:
            print(f"{tag} run_gpu_msm: bit-exact; first call {first * 1e3:.2f} ms", flush=True)
        else:
            torch.cuda.reset_peak_memory_stats()
            med, runs = _median_ms(lambda: run(pts, ks), 3)
            st = stage_times(pts, ks, cfg, path, device)
            print(f"{tag} run_gpu_msm: bit-exact; wall_ms median of 3 = {med:.2f} (runs "
                  f"{', '.join(f'{r:.2f}' for r in runs)}); peak_mem_gib="
                  f"{torch.cuda.max_memory_allocated() / 2**30:.3f}; stages_ms "
                  + ", ".join(f"{k}={v:.1f}" for k, v in st.items()), flush=True)
    t0 = time.perf_counter()
    plan = msm_tpu_torch.plan(pts, config=cfg, device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    _reset_counts()
    if not cv.eq(plan.jpoint(words), want):
        raise AssertionError(f"{tag}: the plan's words call differs from the oracle")
    _counts_of(f"{tag} plan words call", f"plan_{name}")
    torch.cuda.reset_peak_memory_stats()
    med, runs = _median_ms(lambda: plan.jpoint(words), 5)
    peak = torch.cuda.max_memory_allocated() / 2**30
    line = (f"{tag} plan words call: bit-exact; build {build_s:.2f} s; wall_ms median of 5 = {med:.2f} "
            f"(runs {', '.join(f'{r:.2f}' for r in runs)}); peak_mem_gib={peak:.3f}")
    if not detail:
        print(line, flush=True)
    else:
        st = plan_stage_times(plan, words)
        wall_ms, busy_ms, by_name = device_breakdown(
            lambda _pts, w: plan.jpoint(w), None, words, BUILD_ROOT / f"trace_{name}_2e{logn}.json")
        print(f"{line}; stages_ms " + ", ".join(f"{k}={v:.2f}" for k, v in st.items()), flush=True)
        print(f"{tag} plan words call profiled: wall_ms={wall_ms:.2f} device_busy_ms={busy_ms:.2f} "
              f"kernel_ms={busy_ms - by_name.get('memcpy', 0.0):.2f} idle_share={1 - busy_ms / wall_ms:.3f}; "
              "device_ms " + ", ".join(f"{k}={v:.2f}" for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])),
              flush=True)
    del plan
    torch.cuda.empty_cache()
    return counts, med


def run_curve_entry_checks() -> None:
    """The command line and the bench on other curves, in this process with
    the counters reset just before and the curve's kernels required just
    after: verify --size 12 on BLS12-381 and secp256k1 (bit-exact against
    the pure-Python oracle over every point), and the bench's --plan 4
    --size 20 line on BLS12-381, verified against its folded oracle."""
    from msm_tpu_torch import bench, cli

    for curve in ("bls12_381", "secp256k1"):
        argv = ["verify", "--size", "12", "--curve", curve]
        line = _in_process(cli.main, argv, f"cli {' '.join(argv)}", f"curve_{curve}")
        if json.loads(line).get("bit_exact") is not True:
            raise AssertionError(f"cli {' '.join(argv)}: {line}")
    argv = ["--plan", "4", "--size", "20", "--verify", "--curve", "bls12_381"]
    line = _in_process(bench.main, argv, f"bench {' '.join(argv)}", "curve_bls12_381")
    if json.loads(line).get("verified") is not True:
        raise AssertionError(f"bench {' '.join(argv)}: not verified: {line}")


def run_curves_phase(so, clock_hz: float, device="cuda") -> list[dict]:
    """The curves phase: each curve's six plain kernel instances against
    their twins at the small shapes and at the shapes of its largest plain
    MSM below (2^20 for CURVES_AT_2E20, else 2^16), its seven instances of
    the compressed and GLV configs at the small shapes and at the shapes
    of its 2^16 MSMs on those configs (check_curve_config_kernels), its six
    OFFPATH_KERNELS at the shapes of its 2^16 MSMs (the pair kernels at
    its 2^20 MSMs' for CONFIGS_AT_2E20; check_curve_offpath_kernels), each
    curve's checks settled before the next curve's, then the curves' MSMs on the four
    configs with the OFFPATH_KERNELS' paths and the subgroup checks
    (run_curve_msms) and the command line and bench on them
    (run_curve_entry_checks). Returns the kernel table's
    rows for the instances, each with its launches in its curve's 2^16
    run_gpu_msm on the config that runs it and the times at its largest
    checked shape."""
    t0 = t_all = time.perf_counter()

    def step(name):
        nonlocal t0
        print(f"curves phase, {name}: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()

    kern = _kernels()
    dev = torch.device(device)
    checks = {}
    for curve in CURVE_NAMES:
        # the MSM shapes first (their chain twins, the longest, overlap the
        # rest); a kernel's result is its MSM shape's
        large = check_curve_offpath_kernels(kern, curve, 20 if curve in CONFIGS_AT_2E20 else 16, clock_hz, dev)
        large.update(check_curve_config_kernels(kern, curve, 16, clock_hz, dev))
        large.update(check_curve_kernels(kern, curve, 20 if curve in CURVES_AT_2E20 else 16, clock_hz, dev))
        small = check_curve_config_kernels(kern, curve, None, clock_hz, dev)
        small.update(check_curve_kernels(kern, curve, None, clock_hz, dev))
        checks[curve] = {**small, **large}
        settle()
    step("kernels, config kernels, pair-value, bpr and scaled convert kernels")
    counts = run_curve_msms(device)
    step("msms")
    run_curve_entry_checks()
    step("cli and bench")
    rows = []
    for curve in CURVE_NAMES:
        for name in CURVE_KERNELS + tuple(CONFIG_KERNELS) + tuple(OFFPATH_KERNELS):
            c = checks[curve][name]
            path = CONFIG_KERNELS.get(name) or OFFPATH_KERNELS.get(name, "plain")
            unit = CURVE_INSTANCES[name][2]
            rows.append({
                "name": f"{name}[{curve}]", "route": "cuda", "source": f"msm_tpu_torch/csrc/curve_{curve}{unit}.cu",
                "replaces": f"{REPLACES[name][1]} ({curve})", "launches": counts[(curve, path)][name],
                "max_abs_err": c["max_abs_err"], "ms": c["ms"], "plain_ms": c["plain_ms"],
                "bound_ms": c["bound_ms"], "bound_by": c["bound_by"], "library_ms": None,
                **_ptxas_fields(curve, name),
            })
    print(f"curves phase: {time.perf_counter() - t_all:.1f} s", flush=True)
    return rows


#: the shard counts of the sharded phase's 2^20 BN254 plain runs (all on
#: the one card: the shards run in turn)
SHARDS = (1, 2, 4)
#: its multi-process runs: (ranks, backend); every rank on cuda:0
MULTIHOST_RUNS = ((2, "gloo"), (1, "nccl"))


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def start_multihost_runs(logn: int = 16) -> list[tuple[str, list[subprocess.Popen]]]:
    """MULTIHOST_RUNS through ``python -m msm_tpu_torch.bench --sharded R
    --multihost --verify --size logn``, each rank a process of its own at a
    localhost port (loopback only: GLOO_SOCKET_IFNAME and NCCL_SOCKET_IFNAME
    set to lo), all started at once; read by finish_multihost_runs."""
    env = {**os.environ, "GLOO_SOCKET_IFNAME": "lo", "NCCL_SOCKET_IFNAME": "lo"}
    runs = []
    for ranks, backend in MULTIHOST_RUNS:
        port = _free_port()
        argv = ["--sharded", str(ranks), "--multihost", "--backend", backend, "--coordinator", f"localhost:{port}",
                "--num-processes", str(ranks), "--size", str(logn), "--verify", "--reps", "3"]
        runs.append((f"multihost {ranks} rank(s) {backend} 2^{logn}", [
            subprocess.Popen([sys.executable, "-m", "msm_tpu_torch.bench", *argv, "--process-id", str(r)],
                             cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                             start_new_session=True)
            for r in range(ranks)]))
    return runs


def finish_multihost_runs(runs, want_xy) -> None:
    """Each multi-process run: every rank must exit 0, print its result
    (equal on every rank and to ``want_xy``, the oracle's affine point as
    hex), rank 0 alone the verified JSON line; a rank still running after
    the deadline is killed with its session and fails the phase."""
    deadline = time.perf_counter() + 300
    for tag, procs in runs:
        outs = []
        try:
            for proc in procs:
                outs.append(proc.communicate(timeout=max(1.0, deadline - time.perf_counter())))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()
        for r, (proc, (out, err)) in enumerate(zip(procs, outs)):
            if proc.returncode != 0:
                raise AssertionError(f"{tag}: rank {r} exit {proc.returncode}\n{out}\n{err[-4000:]}")
        results = [re.search(r"rank (\d+) of (\d+) on (\S+) \((\w+)\): result (.*?); verified True", err)
                   for _, err in outs]
        if any(m is None for m in results):
            raise AssertionError(f"{tag}: a rank printed no verified result: {[e[-2000:] for _, e in outs]}")
        xys = {m.group(5) for m in results}
        if xys != {want_xy}:
            raise AssertionError(f"{tag}: ranks' results {xys} differ from each other or from the oracle")
        lines = [out.strip() for out, _ in outs]
        if lines[0].count("\n") != 0 or any(lines[1:]) or json.loads(lines[0]).get("verified") is not True:
            raise AssertionError(f"{tag}: rank 0 alone must print one verified line: {lines}")
        ranks = ", ".join(f"rank {m.group(1)} on {m.group(3)} ({m.group(4)})" for m in results)
        print(f"{tag}: every rank bit-exact and equal ({ranks}); {lines[0]}", flush=True)


def _tree_check(tag: str, parts, cfg, device) -> torch.Tensor:
    """The point-add tree alone over the shards' window sums ``parts``,
    counters reset just before and every kernel-1 batch recorded: D - 1
    additions a window in log2 D launches. Returns the merged sums."""
    from msm_tpu_torch.ops.curve import get_curve_ctx
    from msm_tpu_torch.parallel.sharded import merge_shards

    d, S = len(parts), parts[0].shape[0]
    lanes = []
    ec = get_curve_ctx(cfg)  # the instance the tree adds with

    def recorded(p, q):
        lanes.append(p.x[..., 0].numel())
        return type(ec).add(ec, p, q)

    _reset_counts()
    ec.add = recorded
    try:
        merged = merge_shards(parts, cfg, device)
        torch.cuda.synchronize()
    finally:
        del ec.add
    launches = _kernels()["point_add"][0].launches
    if launches != (d - 1).bit_length() or sum(lanes) != (d - 1) * S or launches != len(lanes):
        raise AssertionError(f"{tag}: tree of {launches} K1 launches over lanes {lanes}; want "
                             f"{(d - 1).bit_length()} launches, {d - 1} additions of {S} windows")
    print(f"{tag}: tree {launches} K1 launch(es), {sum(lanes) // S} additions of {S} windows "
          f"(lanes per launch {lanes})", flush=True)
    return merged


def run_sharded_phase(inputs, device="cuda") -> None:
    """The sharded phase (parallel/): MULTIHOST_RUNS started first, beside
    the untimed checks only: sharded_window_sums over SHARDS shards of the
    2^20 BN254 plain MSM (run_msm_checks' inputs, uploaded once) with the
    counters reset just before, bit-exact against the folded oracle, its K1
    tree checked alone (_tree_check; the full run's K1 launches less the
    shards' own are the tree's); plan_sharded with D = 2 at 2^20: an ints
    call, a words call and run_batch of 2, bit-exact. Then the multi-process
    runs' results (finish_multihost_runs), and with no other process left:
    D = 2 at 2^16 through run_gpu_msm_sharded for the compressed and GLV
    configs and BLS12-381 plain (the curves phase's inputs), each call's
    seconds; each shard count's wall median of 3 and, per shard, the host's
    issue time and the device's span of its pass (_issue_times); the
    sharded plan's words call's median of 5 beside the single-device
    plan's, the two taken in turn. The bench processes are killed if the
    checks fail before them."""
    t_all = time.perf_counter()
    runs = start_multihost_runs()
    try:
        _sharded_checks(runs, inputs, device)
    finally:
        for _, procs in runs:
            for proc in procs:
                if proc.poll() is None:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()
    print(f"sharded phase: {time.perf_counter() - t_all:.1f} s", flush=True)


def _issue_times(shards, cfg, geom, devices, reps: int = 3) -> tuple[list[float], list[float], float]:
    """One sharded 2^20 MSM from inputs on the card, ``reps`` times, the
    card idle before each: (per shard, the median host ms until its pass
    returns from shard_window_sums, before any wait; per shard, the median
    device ms between CUDA events recorded around that issue; the median
    wall ms of the whole MSM, tree, Horner and copy back included)."""
    from msm_tpu_torch.models import common, cuzk
    from msm_tpu_torch.parallel.sharded import merge_shards, shard_window_sums

    issue, span, wall = [], [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2 * len(shards))]
        host, parts = [], []
        t0 = time.perf_counter()
        for i, (rows, dv) in enumerate(zip(shards, devices)):
            t = time.perf_counter()
            events[2 * i].record()
            parts.append(shard_window_sums([rows], cfg, geom, [dv])[0])
            events[2 * i + 1].record()
            host.append((time.perf_counter() - t) * 1e3)
        ws = merge_shards(parts, cfg, devices[0])
        common.std_ints_to_jpoint(*cuzk.msm_point_from_ws(ws, cfg), cfg)
        wall.append((time.perf_counter() - t0) * 1e3)
        issue.append(host)
        span.append([events[2 * i].elapsed_time(events[2 * i + 1]) for i in range(len(shards))])
    med = [statistics.median(col) for col in zip(*issue)], [statistics.median(col) for col in zip(*span)]
    return *med, statistics.median(wall)


def _sharded_checks(runs, inputs, device) -> None:
    """run_sharded_phase's checks and timings, the multi-process ``runs``
    started."""
    import msm_tpu_torch
    from msm_tpu_torch import bench
    from msm_tpu_torch.models import common, cuzk
    from msm_tpu_torch.models.geometry import pick_geometry
    from msm_tpu_torch.oracle.pyecc import Curve
    from msm_tpu_torch.params import BN254
    from msm_tpu_torch.parallel.sharded import shard_window_sums, sharded_window_sums, split_rows

    cv = Curve(BN254)
    base, pts, ks, want = inputs[20]
    n = len(pts)
    cfg, _ = msm_path("plain", n, device)
    dev = torch.device(device)
    arrays = [torch.from_numpy(a).to(dev) for a in common.pad_inputs(pts, ks, cfg, multiple=16 * max(SHARDS))]
    runners = {}
    for d in SHARDS:
        devices = [dev] * d
        geom = pick_geometry(min(n // d, cuzk.CHUNK_MAX), cfg)
        tag = f"sharded 2^20 plain D={d} (c={cfg.chunk_size} S={cfg.num_subtasks})"

        def run(devices=devices, geom=geom):
            ws = sharded_window_sums(*arrays, cfg, geom, devices)
            return common.std_ints_to_jpoint(*cuzk.msm_point_from_ws(ws, cfg), cfg)

        _reset_counts()
        got = run()
        full = _counts_of(tag, "plain")
        if not cv.eq(got, want):
            raise AssertionError(f"{tag} differs from the oracle")
        _reset_counts()
        parts = shard_window_sums(split_rows(arrays, d), cfg, geom, devices)
        torch.cuda.synchronize()
        own = _kernels()["point_add"][0].launches
        merged = _tree_check(tag, parts, cfg, dev)
        if full["point_add"] - own != (d - 1).bit_length():
            raise AssertionError(f"{tag}: {full['point_add']} K1 launches, the shards' own {own}")
        if not cv.eq(common.std_ints_to_jpoint(*cuzk.msm_point_from_ws(merged, cfg), cfg), want):
            raise AssertionError(f"{tag}: the tree over the shards differs from the oracle")
        print(f"{tag}: bit-exact", flush=True)
        runners[d] = (tag, run, split_rows(arrays, d), geom, devices)
    words = common.ints_to_u16_array(ks)
    sets = batch_sets(base, n, 2, SEED + 90)
    ptag = f"plan_sharded 2^20 plain D=2 (c={cfg.chunk_size} S={cfg.num_subtasks})"
    _reset_counts()
    t0 = time.perf_counter()
    splan = msm_tpu_torch.plan_sharded(pts, devices=[dev] * 2, config=cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if _kernels()["convert_pack"][0].launches != 2:
        raise AssertionError(f"{ptag}: the build did not launch the convert once a shard")
    want_aff = cv.to_affine(want)
    for label, scalars in (("ints", ks), ("words", words)):
        _reset_counts()
        got = splan(scalars)
        torch.cuda.synchronize()
        _counts_of(f"{ptag} {label} call", "plan_plain")
        if got != want_aff:
            raise AssertionError(f"{ptag}: the {label} call differs from the oracle")
    _reset_counts()
    got = splan.run_batch([w for w, _ in sets])
    _counts_of(f"{ptag} run_batch B=2", "plan_plain")
    if not all(cv.eq(g, w) for g, (_, w) in zip(got, sets)):
        raise AssertionError(f"{ptag}: run_batch differs from the oracle")
    print(f"{ptag}: build {build_s:.3f} s; bit-exact (ints, words, run_batch B=2)", flush=True)
    mpts, mks = bench.sample_inputs(1 << 16, BN254, 0)
    mwant = bench.folded_oracle(mpts[:bench.NBASE], common.ints_to_u16_array(mks))
    finish_multihost_runs(runs, " ".join(hex(v) for v in cv.to_affine(mwant)))
    # every timing below runs with no other process of this script alive
    cases = [(path, BN254, *inputs[16]) for path in ("compressed", "glv")]
    b381 = CURVE_INPUTS[("bls12_381", 16)]
    cases.append(("plain", _curve_spec("bls12_381"), b381[0], b381[1],
                  [int.from_bytes(w.tobytes(), "little") for w in b381[2]], b381[3]))
    for path, curve, _base, cpts, cks, cwant in cases:
        c, _ = msm_path(path, len(cpts), device, curve=curve)
        tag = f"sharded 2^16 {curve.name} {path} D=2"
        _reset_counts()
        t0 = time.perf_counter()
        got = msm_tpu_torch.run_gpu_msm_sharded(cpts, cks, c, devices=[dev] * 2)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        _counts_of(tag, path)
        if not Curve(curve).eq(got, cwant):
            raise AssertionError(f"{tag} differs from the oracle")
        print(f"{tag}: bit-exact; {secs:.3f} s", flush=True)
    for d, (tag, run, shards, geom, devices) in runners.items():
        wall, walls = _median_ms(run, 3)
        issue, span, iwall = _issue_times(shards, cfg, geom, devices)
        print(f"{tag}: wall_ms median of 3 = {wall:.2f} (runs {', '.join(f'{w:.2f}' for w in walls)}); "
              f"per shard, medians of 3: host issue ms {', '.join(f'{t:.3f}' for t in issue)} (sum "
              f"{sum(issue):.3f}), device span ms {', '.join(f'{t:.3f}' for t in span)} (sum {sum(span):.3f}); "
              f"that run's wall {iwall:.2f}", flush=True)
    plan = msm_tpu_torch.plan(pts, config=cfg, device=device)
    single, sharded = [], []
    for _ in range(5):
        single.append(_median_ms(lambda: plan(words), 1)[0])
        sharded.append(_median_ms(lambda: splan(words), 1)[0])
    print(f"{ptag}: words wall_ms median of 5 sharded {statistics.median(sharded):.2f} (runs "
          f"{', '.join(f'{w:.2f}' for w in sharded)}) vs one device {statistics.median(single):.2f} (runs "
          f"{', '.join(f'{w:.2f}' for w in single)}), in turn", flush=True)
    del splan, plan


#: the narrow library's widths by phase: 12 in the width-12 phase, the
#: others in the narrow-widths phase, in this order
NARROW_PHASE_WIDTHS = (8, 11, 10, 9)
#: by width, the curves whose narrow instances are also held at their
#: 2^20 MSMs' shapes (every curve's at the small shapes; every curve's 2^16
#: MSMs at that width run them all): at 12 those whose 2^20 MSMs run at
#: that width (run_width_phase), at 8 the widest rows (L 33 and 49)
AT_2E20 = {12: ("bn254", "bls12_381"), 8: ("bn254", "bls12_381")}
#: the widths whose 2^16 MSMs also drive the off-path runs
#: (run_curve_offpath_paths); at the others those instances are held
#: against their twins only
OFFPATH_WIDTHS = (12,)


#: the narrow library's build (widths 8 to 12), in a process of its own at
#: nice 19 on half the host's cores (its nvcc processes inherit both),
#: behind the 13-bit build and beside the 13-bit phases: it takes the cores
#: they leave idle
BUILD_NARROW = ("import os; os.nice(19); cpus = sorted(os.sched_getaffinity(0)); "
                "os.sched_setaffinity(0, cpus[len(cpus) // 2:]); "
                "from msm_tpu_torch.ops import _build; _build.build(12)")


class NarrowBuild:
    """The narrow library's build (BUILD_NARROW) in a process of its own
    (a process group of its own, so stop ends its nvcc processes too; its
    nice value ranks it below this process's work)
    and a thread that waits for it and then runs cuobjdump over its kernel
    objects (_prefetch_sass), beside the 13-bit phases."""

    def __init__(self) -> None:
        self.proc = subprocess.Popen([sys.executable, "-c", BUILD_NARROW], cwd=ROOT, process_group=0,
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.log = ""
        self.thread = threading.Thread(target=self._wait, daemon=True)
        self.thread.start()

    def _wait(self) -> None:
        from msm_tpu_torch.ops import _build

        self.log, _ = self.proc.communicate()
        if self.proc.returncode == 0:
            _prefetch_sass(_kernel_objects(_build.library_path(12).parent))

    def finish(self) -> tuple[Path, float]:
        """Wait for the build (a failed build fails the run) and load the
        library; returns (library, the build's wall seconds)."""
        from msm_tpu_torch.ops import _build

        self.thread.join()
        if self.proc.returncode != 0:
            raise RuntimeError(f"the narrow library's build failed (exit {self.proc.returncode}):\n{self.log}")
        _build.load(12)
        so = _build.library_path(12)
        return so, json.loads((so.parent / "compile_seconds.json").read_text())["wall"]

    def stop(self) -> None:
        """End the build's process group if it still runs."""
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()


def run_width_phase(word_size: int, clock_hz: float, device="cuda") -> list[dict]:
    """The checks of one width of the narrow library (8 to 12): its
    instances of every kernel generic over the field (every wrapper of
    CURVE_INSTANCES) on the seven curves against their twins at the small
    shapes, the curves of AT_2E20[word_size] also at their 2^20 MSMs'
    shapes (a chain kernel's twin over 256 chains on the CPU there), all
    exact after canonicalization; each curve's 2^16 MSM at that width on
    the plain, compressed, GLV and GLV compressed configs (run_gpu_msm and
    a plan's words call, bit-exact against the folded oracle, the curve's
    kernels required: paths curve_<name>[_<config>]_w<width>), at
    OFFPATH_WIDTHS with compress_pairs in both modes, the scaled convert's
    five modes, the blocked stage 4 and the naive model
    (run_curve_offpath_paths). At width 12 also validate=True on BLS12-381
    (check_subgroup), BN254's edge MSMs on the five paths and a
    karatsuba=True MSM at 2^16, and a plan's words call at 2^20 on BN254's
    four configs and BLS12-381's plain one, bit-exact. The twins that run
    in the workers are compared after the 2^16 MSMs (settle), so those
    MSMs' wall times share the host with them; the 2^20 ones run after.
    Returns the kernel
    table's rows, ``name[curve,w<width>]``, each with its launches in its
    curve's 2^16 run on the config (or path) that runs it (0 for an
    off-path instance at a width that does not drive its path) and the
    times at its largest checked shape."""
    import msm_tpu_torch
    from msm_tpu_torch import bench
    from msm_tpu_torch.oracle.pyecc import Curve
    from msm_tpu_torch.params import BN254, pick_config

    t0 = t_all = time.perf_counter()
    w = _w(word_size).strip()

    def step(name):
        nonlocal t0
        print(f"width {word_size} phase, {name}: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()

    curves = ("bn254",) + CURVE_NAMES
    kern = _kernels()
    dev = torch.device(device)
    checks = {}
    for curve in curves:
        # the 2^20 shapes first (their chain twins, the longest, overlap the
        # rest); a kernel's result is its largest shape's
        c = {}
        for logn in (20, None) if curve in AT_2E20.get(word_size, ()) else (None,):
            got = check_curve_config_kernels(kern, curve, logn, clock_hz, dev, word_size)
            got.update(check_curve_offpath_kernels(kern, curve, logn, clock_hz, dev, word_size))
            got.update(check_curve_kernels(kern, curve, logn, clock_hz, dev, word_size))
            c = {**got, **c}
        checks[curve] = c
    # one group a width, settled after the 2^16 MSMs: the curves' twins in
    # the workers overlap each other's kernel checks and those MSMs
    step("kernels issued")
    counts = {}
    for curve in curves:
        spec = _curve_spec(curve)
        if (curve, 16) not in CURVE_INPUTS:
            base, pts, words = sample_curve_msm(curve, 1 << 16, SEED + 76)
            CURVE_INPUTS[(curve, 16)] = (base, pts, words, bench.folded_oracle(base, words, spec))
        base, pts, words, want = CURVE_INPUTS[(curve, 16)]
        ks = [int.from_bytes(x.tobytes(), "little") for x in words]
        for path in ("plain",) + CURVE_CONFIGS:
            counts[(curve, path)] = run_curve_config(curve, path, 16, pts, ks, words, want, device, word_size,
                                                     False)[0]
        if word_size in OFFPATH_WIDTHS:
            for path, c in run_curve_offpath_paths(curve, pts, ks, want, device, word_size).items():
                counts[(curve, path)] = c
        if word_size != 12:
            continue
        if curve == "bls12_381":
            check_subgroup(curve, pts, ks, words, want, device, 12)
        if curve == "bn254":
            cfg = dataclasses.replace(pick_config(1 << 16), word_size=12, karatsuba=True)
            tag = f"curve bn254 w12 2^16 plain karatsuba=True (c={cfg.chunk_size} L={cfg.num_words})"
            _reset_counts()
            got = msm_tpu_torch.run_gpu_msm(pts, ks, config=cfg, device=device)
            torch.cuda.synchronize()
            _counts_of(tag, "curve_bn254_w12")
            if got != Curve(BN254).to_affine(want):
                raise AssertionError(f"{tag}: differs from the oracle: {got}")
            print(f"{tag}: bit-exact", flush=True)
            for path in ("plain", "compressed", "naive", "glv", "glv_compressed"):
                edge_checks(path, device, 12)
    step("2^16 msms" + (" and off-path runs" if word_size in OFFPATH_WIDTHS else "")
         + (", edges, karatsuba and validate" if word_size == 12 else ""))
    settle()
    step("the kernels' twins settled")
    if word_size == 12:
        base, pts, words, want = bn254_2e20_inputs()
        for path in ("plain",) + CURVE_CONFIGS:
            run_curve_config("bn254", path, 20, pts, None, words, want, device, 12)
        base, pts, words, want = CURVE_INPUTS[("bls12_381", 20)]
        run_curve_config("bls12_381", "plain", 20, pts, None, words, want, device, 12)
        step("2^20 msms")
    rows = []
    for curve in curves:
        for name in CURVE_KERNELS + tuple(CONFIG_KERNELS) + tuple(OFFPATH_KERNELS):
            c = checks[curve][name]
            path = CONFIG_KERNELS.get(name) or OFFPATH_KERNELS.get(name, "plain")
            obj, unit = CURVE_INSTANCES[name][1:]
            src = obj.removesuffix(".o") + ".cu" if curve == "bn254" else f"curve_{curve}{unit}.cu"
            rows.append({
                "name": f"{name}[{curve},{w}]", "route": "cuda", "source": f"msm_tpu_torch/csrc/{src}",
                "replaces": f"{REPLACES[name][1]} ({curve}, word_size {word_size})",
                "launches": counts[(curve, path)][name] if (curve, path) in counts else 0,
                "max_abs_err": c["max_abs_err"], "ms": c["ms"], "plain_ms": c["plain_ms"],
                "bound_ms": c["bound_ms"], "bound_by": c["bound_by"], "library_ms": None,
                **_ptxas_fields(curve, name, word_size),
            })
    print(f"width {word_size} phase: {time.perf_counter() - t_all:.1f} s", flush=True)
    return rows


def bn254_2e20_inputs():
    """BN254's 2^20 MSM inputs of the narrow phases (step 5's 1024 bases
    of the 2^16 curve MSM, fresh scalars) and their folded oracle, made
    once (CURVE_INPUTS[("bn254", 20)])."""
    from msm_tpu_torch import bench
    from msm_tpu_torch.params import BN254

    if ("bn254", 20) not in CURVE_INPUTS:
        base = CURVE_INPUTS[("bn254", 16)][0]
        base, pts, words = sample_curve_msm("bn254", 1 << 20, SEED + 80, base)
        CURVE_INPUTS[("bn254", 20)] = (base, pts, words, bench.folded_oracle(base, words, BN254))
    return CURVE_INPUTS[("bn254", 20)]


def run_narrow_phase(clock_hz: float, device="cuda") -> list[dict]:
    """The narrow-widths phase: run_width_phase at each width of
    NARROW_PHASE_WIDTHS (8 to 11; BN254's and BLS12-381's instances at
    their 2^20 MSMs' shapes at width 8, the widest rows: L 33 and 49);
    then BN254's plain 2^20 MSM through a plan's words call at widths 8, 11
    and 13 in turn and BLS12-381's at 8 (each bit-exact, its wall median of
    5, stages, a profiled call's device busy time and idle share, and peak
    device memory); then the library check (check_libraries). Returns the
    kernel table's rows of the four widths."""
    t0 = time.perf_counter()
    rows = []
    for word_size in NARROW_PHASE_WIDTHS:
        rows += run_width_phase(word_size, clock_hz, device)
    t1 = time.perf_counter()
    base, pts, words, want = bn254_2e20_inputs()
    ms = {ws: run_curve_config("bn254", "plain", 20, pts, None, words, want, device, ws)[1] for ws in (8, 11, 13)}
    print("narrow widths: bn254 2^20 plain plan words call wall_ms median of 5: "
          + ", ".join(f"w{ws}={m:.2f} ({m / ms[13]:.3f} of w13)" for ws, m in ms.items()), flush=True)
    base, pts, words, want = CURVE_INPUTS[("bls12_381", 20)]
    run_curve_config("bls12_381", "plain", 20, pts, None, words, want, device, 8)
    print(f"narrow widths phase, 2^20 msms: {time.perf_counter() - t1:.1f} s", flush=True)
    check_libraries(clock_hz, device)
    print(f"narrow widths phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return rows


#: when a list, _check_case holds the narrow library at width 13 against
#: the default library instead of the twin (check_libraries), and records
#: each kernel it compared
_LIB_CHECK: list | None = None


def _compare_libraries(wrapper, name, label, args, L) -> dict:
    """One wrapper's outputs on the default library and on the narrow one
    at width 13 (_build.narrow_at_13: its W = 13 rows of csrc/widths.cuh),
    the same inputs: equal limb for limb (no canonicalization), else
    raises."""
    from msm_tpu_torch.ops import _build

    want = wrapper(*args)
    with _build.narrow_at_13():
        got = wrapper(*args)
    torch.cuda.synchronize()
    (gf, gi), (wf, wi) = _field_outputs(name, got, L), _field_outputs(name, want, L)
    if [a.shape for a in gf + gi] != [b.shape for b in wf + wi]:
        raise AssertionError(f"library check {name} ({label}): shapes differ")
    err = max([int((a.long() - b.long()).abs().max()) for a, b in zip(gf + gi, wf + wi) if a.numel()] + [0])
    print(f"library check {name:13s} {label}: narrow at 13 vs default max_abs_err={err}", flush=True)
    if err != 0:
        raise AssertionError(f"{name} ({label}): the narrow library at 13 differs from the default one: {err}")
    _LIB_CHECK.append(name)
    return {"max_abs_err": err}


def check_libraries(clock_hz: float, device="cuda") -> None:
    """The narrow library at width 13 against the default library, limb for
    limb on the same inputs: every instance of K1, K2 and K4 to K13 (every
    wrapper of CURVE_INSTANCES, in every mode) on the seven curves at the
    small shapes of check_curve_kernels, check_curve_config_kernels and
    check_curve_offpath_kernels (_check_case calls _compare_libraries, no
    twin). A check's hook: no wrapper sends 13 to the narrow library
    outside it."""
    global _LIB_CHECK
    t0 = time.perf_counter()
    kern = _kernels()
    dev = torch.device(device)
    _LIB_CHECK = []
    try:
        for curve in ("bn254",) + CURVE_NAMES:
            check_curve_config_kernels(kern, curve, None, clock_hz, dev, 13)
            check_curve_offpath_kernels(kern, curve, None, clock_hz, dev, 13)
            check_curve_kernels(kern, curve, None, clock_hz, dev, 13)
        missing = set(CURVE_INSTANCES) - set(_LIB_CHECK)
        if missing:
            raise AssertionError(f"library check: no comparison of {sorted(missing)}")
        print(f"library check: {len(_LIB_CHECK)} launches of {len(set(_LIB_CHECK))} wrappers on 7 curves equal "
              f"limb for limb; {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        _LIB_CHECK = None


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke test runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    print(smi, flush=True)
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True,
    ).stdout.split()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}; "
          f"clocks.max.sm {clock_mhz:.0f} MHz")

    from msm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    so = _build.build(13)
    _build.load(13)
    build_s = time.perf_counter() - t0
    build_narrow = NarrowBuild()
    sass13 = threading.Thread(target=_prefetch_sass, args=(_kernel_objects(so.parent),), daemon=True)
    sass13.start()
    try:
        return run_phases(clock_mhz, so, build_s, build_narrow, sass13)
    finally:
        build_narrow.stop()


def run_phases(clock_mhz: float, so: Path, build_s: float, build_narrow: NarrowBuild,
               sass13: threading.Thread) -> int:
    """Every phase after the 13-bit build (main): the 13-bit phases, the
    13-bit library's ptxas and SASS report (report_plain_builds, its SASS
    read by ``sass13`` beside the first phases) before the curves phase,
    the narrow library's phases (width 12, then 8 to 11 and the library
    check) once build_narrow has ended, the kernels line and the last
    line."""
    from msm_tpu_torch.oracle import native

    print(f"build: {build_s:.1f} s -> {so}", flush=True)
    print(f"compile seconds by translation unit: {(so.parent / 'compile_seconds.json').read_text()}", flush=True)

    print(f"oracle: {'C++' if native.native_available() else 'python'}", flush=True)
    phase_t0 = time.perf_counter()

    def phase(name):
        nonlocal phase_t0
        print(f"phase {name}: {time.perf_counter() - phase_t0:.1f} s", flush=True)
        phase_t0 = time.perf_counter()

    checks = check_kernels(clock_mhz * 1e6)
    pair_counts = {"pairs": check_pairs(), "pairs_glv": check_pairs(glv=True),
                   "convert_scaled": run_convert_scaled()}
    phase("kernels and pairs")
    for path in ("plain", "compressed", "naive", "glv", "glv_compressed"):
        edge_checks(path)
    msm_counts, inputs = run_msm_checks()
    by_path = {**msm_counts, **pair_counts}
    phase("edge and msm")
    run_plan_checks(inputs)
    check_batched()
    compare_uploads(inputs[20][2])
    phase("plan and batched")
    run_cli_checks()
    run_bench_checks()
    phase("cli and bench")
    base, pts20 = inputs[20][:2]
    run_chunked_checks(base, pts20, {path: c["point_add"] for path, c in msm_counts.items()})
    run_beyond_checks(base)
    phase("chunked and beyond")
    sass13.join()
    report_plain_builds(so)
    phase("the 13-bit library's ptxas and SASS")
    curve_rows = run_curves_phase(so, clock_mhz * 1e6)
    phase("curves")
    run_sharded_phase(inputs)
    phase("sharded")
    t0 = time.perf_counter()
    so_n, build_n_s = build_narrow.finish()
    print(f"build narrow: {build_n_s:.1f} s at nice 19 on half the cores beside the 13-bit phases (waited "
          f"{time.perf_counter() - t0:.1f} s for it after the 13-bit phases) -> {so_n}", flush=True)
    print(f"compile seconds by translation unit (narrow): {(so_n.parent / 'compile_seconds.json').read_text()}",
          flush=True)
    from msm_tpu_torch.ops._build import NARROW_WIDTHS

    report_plain_builds(so_n, 12, NARROW_WIDTHS)
    phase("narrow library's ptxas and SASS")
    narrow_rows = run_width_phase(12, clock_mhz * 1e6)
    phase("width 12")
    narrow_rows += run_narrow_phase(clock_mhz * 1e6)
    phase("narrow widths")
    rows = []
    for name, (src, rep) in REPLACES.items():
        c = checks[name]
        path = next(p for p, names in PATHS.items() if name in names)
        rows.append({
            "name": name, "route": "cuda", "source": f"msm_tpu_torch/{src}",
            "replaces": rep, "launches": by_path[path][name],
            "max_abs_err": c["max_abs_err"], "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            **_ptxas_fields("bn254", name),
        })
    if _TWIN_POOL is not None:
        _TWIN_POOL.shutdown()
    print(json.dumps({"kernels": rows + curve_rows + narrow_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
