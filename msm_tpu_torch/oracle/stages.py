"""CPU models of every cuZK pipeline stage (numpy and python-int points)
— the port's own copy of ``msm_tpu/oracle/stages.py``, on the port's
oracle (``oracle/pyecc.py``) and config (``params.py``):

- ``decompose_scalars_signed``: signed windowed digits with carries;
- ``cpu_transpose``: the bucket grouping (histogram, prefix, stable
  scatter);
- ``cpu_smvp_signed``: signed bucket sums of one subtask;
- ``serial_bucket_reduction``, ``running_sum_bucket_reduction``,
  ``parallel_bucket_reduction`` and its two phases
  (``parallel_bucket_reduction_1``, ``_2``): the four bucket reductions;
- ``horner``: the window sums' finish;
- ``cuzk_cpu_msm``: the whole pipeline on the host.

The models run the parallel decomposition explicitly (a loop a thread), so
they check the parallel algebra, not only the result. A host model: it
touches no device.
"""

from __future__ import annotations

import numpy as np

from msm_tpu_torch.oracle.pyecc import IDENTITY, Curve, JPoint
from msm_tpu_torch.params import MsmConfig


# ---------------------------------------------------------------------------
# Stage 1 — signed scalar decomposition
# ---------------------------------------------------------------------------


def decompose_scalars_signed(
    scalars: list[int], num_subtasks: int, chunk_size: int
) -> np.ndarray:
    """Signed-digit windowed decomposition with carry propagation.

    Returns int32 [num_subtasks, n] of digits in [-2^(c-1), 2^(c-1)-1] for
    all but the top window (the top window absorbs the final carry and stays
    within [0, 2^(c-1)) for valid scalars). Invariant:
        scalar = sum_j digit[j] * 2^(c*j).

    Reference semantics: slice >= 2^(c-1) -> digit = slice - 2^c, carry = 1
    (decompose_scalars.template.wgsl:89-103, test/utils.rs:121-161).
    """
    c = chunk_size
    half = 1 << (c - 1)
    full = 1 << c
    mask = full - 1
    n = len(scalars)
    out = np.zeros((num_subtasks, n), dtype=np.int32)
    for i, s in enumerate(scalars):
        carry = 0
        for j in range(num_subtasks):
            w = ((s >> (c * j)) & mask) + carry
            if j == num_subtasks - 1:
                digit = w
                carry = 0
            elif w >= half:
                digit = w - full
                carry = 1
            else:
                digit = w
                carry = 0
            out[j, i] = digit
        assert carry == 0
    return out


# ---------------------------------------------------------------------------
# Stage 2 — sparse transpose (CSR->CSC): group point indices by bucket
# ---------------------------------------------------------------------------


def cpu_transpose(
    digits: np.ndarray, num_buckets: int
) -> tuple[np.ndarray, np.ndarray]:
    """Serial CSR->CSC transpose per subtask, exactly as the reference's
    single-thread-per-subtask GPU kernel does it (histogram, prefix sum,
    scatter — transpose.template.wgsl:32-75; CPU model test/utils.rs:61-118).

    Input: digits int [num_subtasks, n] (signed); bucket key = |digit|.
    Returns (csc_col_ptr [num_subtasks, num_buckets+1],
             csc_val_idxs [num_subtasks, n]) where val_idxs lists point
    indices grouped by bucket, preserving input order within a bucket (the
    scatter pass is stable).
    """
    num_subtasks, n = digits.shape
    col_ptr = np.zeros((num_subtasks, num_buckets + 1), dtype=np.int64)
    val_idxs = np.zeros((num_subtasks, n), dtype=np.int64)
    keys = np.abs(digits.astype(np.int64))
    for t in range(num_subtasks):
        counts = np.zeros(num_buckets + 1, dtype=np.int64)
        for i in range(n):
            counts[keys[t, i] + 1] += 1
        ptr = np.cumsum(counts)
        col_ptr[t] = ptr
        fill = ptr[:-1].copy()
        for i in range(n):
            b = keys[t, i]
            val_idxs[t, fill[b]] = i
            fill[b] += 1
    return col_ptr, val_idxs


# ---------------------------------------------------------------------------
# Stage 3 — SMVP: signed bucket accumulation
# ---------------------------------------------------------------------------


def cpu_smvp_signed(
    subtask_digits: np.ndarray,
    col_ptr: np.ndarray,
    val_idxs: np.ndarray,
    points: list[JPoint],
    cv: Curve,
) -> list[JPoint]:
    """Per-bucket signed point accumulation for ONE subtask.

    bucket[b] = sum over {i : |digit_i| == b} of sign(digit_i) * P_i,
    for b in 0..num_buckets-1 (bucket 0 carries multiplier 0 and is unused
    downstream). Mirrors smvp.template.wgsl:31-117 / test/utils.rs:166-219.
    """
    num_buckets = col_ptr.shape[0] - 1
    out = []
    for b in range(num_buckets):
        acc = IDENTITY
        for k in range(col_ptr[b], col_ptr[b + 1]):
            i = int(val_idxs[k])
            pt = points[i]
            if subtask_digits[i] < 0:
                pt = cv.neg(pt)
            acc = cv.add(acc, pt)
        out.append(acc)
    return out


# ---------------------------------------------------------------------------
# Stage 4 — bucket point reduction (4 variants, cross-checked like
# tests/cuzk.rs:52-76)
# ---------------------------------------------------------------------------


def serial_bucket_reduction(buckets: list[JPoint], cv: Curve) -> JPoint:
    """W = sum_b b * S_b by direct scalar-mul (test/utils.rs:222-235)."""
    acc = IDENTITY
    for b, s in enumerate(buckets):
        if b == 0 or s.is_identity():
            continue
        acc = cv.add(acc, cv.scalar_mul(s, b))
    return acc


def running_sum_bucket_reduction(buckets: list[JPoint], cv: Curve) -> JPoint:
    """Descending running-sum identity (test/utils.rs:238-251)."""
    running = IDENTITY
    acc = IDENTITY
    for s in reversed(buckets[1:]):  # multipliers B-1 .. 1 (index 0 excluded)
        running = cv.add(running, s)
        acc = cv.add(acc, running)
    return acc


def parallel_bucket_reduction(
    buckets: list[JPoint], cv: Curve, num_threads: int = 4
) -> JPoint:
    """cuZK Alg.4: T threads each reduce a contiguous descending block of
    buckets to (g_t, m_t); W = sum_t g_t + sum_t offset_t * m_t
    (test/utils.rs:255-284, bpr.template.wgsl:66-126): phase 1, then
    phase 2."""
    gs, ms = parallel_bucket_reduction_1(buckets, cv, num_threads)
    return parallel_bucket_reduction_2(gs, ms, len(buckets) - 1, cv)


def parallel_bucket_reduction_1(
    buckets: list[JPoint], cv: Curve, num_threads: int = 4
) -> tuple[list[JPoint], list[JPoint]]:
    """Phase 1: per-thread (g, m) pairs (reference bpr stage_1,
    test/utils.rs:287-311)."""
    body = buckets[1:]  # multipliers 1..B-1
    nb = len(body)
    assert nb % num_threads == 0
    per = nb // num_threads
    gs, ms = [], []
    for t in range(num_threads):
        # thread t covers multipliers offset+1 .. offset+per (descending scan)
        offset = t * per
        m = IDENTITY
        g = IDENTITY
        for k in range(per, 0, -1):
            m = cv.add(m, body[offset + k - 1])
            g = cv.add(g, m)
        gs.append(g)
        ms.append(m)
    return gs, ms


def parallel_bucket_reduction_2(
    gs: list[JPoint], ms: list[JPoint], num_buckets_body: int, cv: Curve
) -> JPoint:
    """Phase 2: add the m_t * offset_t corrections (reference bpr stage_2,
    test/utils.rs:313-338)."""
    num_threads = len(gs)
    per = num_buckets_body // num_threads
    total = IDENTITY
    for t in range(num_threads):
        total = cv.add(total, gs[t])
        offset = t * per
        if offset:
            total = cv.add(total, cv.scalar_mul(ms[t], offset))
    return total


# ---------------------------------------------------------------------------
# Finalization — Horner over subtask window sums (msm.rs:409-416)
# ---------------------------------------------------------------------------


def horner(window_sums: list[JPoint], chunk_size: int, cv: Curve) -> JPoint:
    acc = window_sums[-1]
    for w in reversed(window_sums[:-1]):
        for _ in range(chunk_size):
            acc = cv.double(acc)
        acc = cv.add(acc, w)
    return acc


# ---------------------------------------------------------------------------
# The full pipeline on CPU (reference tests/cuzk.rs:11-95)
# ---------------------------------------------------------------------------


def cuzk_cpu_msm(
    points: list[JPoint],
    scalars: list[int],
    cfg: MsmConfig,
    bpr_variant: str = "running_sum",
    num_threads: int = 4,
) -> JPoint:
    cv = Curve(cfg.curve)
    digits = decompose_scalars_signed(scalars, cfg.num_subtasks, cfg.chunk_size)
    col_ptr, val_idxs = cpu_transpose(digits, cfg.num_buckets)
    window_sums = []
    for t in range(cfg.num_subtasks):
        buckets = cpu_smvp_signed(digits[t], col_ptr[t], val_idxs[t], points, cv)
        if bpr_variant == "serial":
            w = serial_bucket_reduction(buckets, cv)
        elif bpr_variant == "running_sum":
            w = running_sum_bucket_reduction(buckets, cv)
        elif bpr_variant == "parallel":
            w = parallel_bucket_reduction(buckets, cv, num_threads)
        elif bpr_variant == "two_phase":
            gs, ms = parallel_bucket_reduction_1(buckets, cv, num_threads)
            w = parallel_bucket_reduction_2(gs, ms, len(buckets) - 1, cv)
        else:
            raise ValueError(bpr_variant)
        window_sums.append(w)
    return horner(window_sums, cfg.chunk_size, cv)
