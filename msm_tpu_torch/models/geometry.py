"""Launch geometry: input size -> scan blocking — the same interface as
``msm_tpu/models/geometry.py``.

- ``num_rows``: lanes R of the blocked prefix scan; the scan kernel runs one
  thread per lane for C = n / R steps.
- ``bpr_threads``: lanes T per subtask of the two-phase blocked bucket
  reduction; callers pass it to ``scan.bucket_reduce_blocked`` (kernel 8
  runs one thread per subtask and lane). The cuZK main path reduces by the
  telescoped ``window_sum_from_pe`` instead and does not read it.
- ``subtask_batch``: how many subtasks the scan processes per launch; it
  bounds the boundary-prefix buffer at subtask_batch * n * 3L * 4 bytes
  (half that when pair-compressed).

The rule is a placeholder copied from the TPU reference and has not been
tuned on the H100. Under pair compression it keeps the reference's narrow
R = min(n/8, 1024): one Fermat inversion per lane, but at 2^20 only 4 x 1024
chains of 512 serial pair steps per launch, far too few threads for the
card.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class MsmGeometry:
    num_rows: int
    bpr_threads: int
    subtask_batch: int


def pick_geometry(n: int, chunk_size: int, compress: bool = False) -> MsmGeometry:
    """n must be a power of two (the host pads)."""
    assert n & (n - 1) == 0 and n > 0
    num_rows = max(1, min(n // 8, 1 << 10 if compress else 1 << 14))
    body = 1 << (chunk_size - 1)
    bpr_threads = max(1, min(body // 16, 1 << 9))
    return MsmGeometry(num_rows, bpr_threads, subtask_batch=4)
