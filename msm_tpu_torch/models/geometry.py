"""Launch geometry: input size and config -> scan blocking — the rule of
``msm_tpu/models/geometry.py``, given the whole config (its window width,
compression, GLV and limb count) where that module takes them one by one.

- ``num_rows``: lanes R of the blocked prefix scan; the scan kernel runs one
  thread per lane for C = n / R steps.
- ``bpr_threads``: lanes T per subtask of the two-phase blocked bucket
  reduction; callers pass it to ``scan.bucket_reduce_blocked`` (kernel 8
  runs one chain per subtask and lane, each on a group of a few lanes of a
  warp). The cuZK main path reduces by the telescoped
  ``window_sum_from_pe`` instead and does not read it.
- ``subtask_batch``: how many subtasks the scan processes per launch; it
  bounds the boundary-prefix buffer at subtask_batch * m * 3L * 4 bytes for
  a stream of m entries a subtask (half that when pair-compressed); m is n,
  or 2n under GLV, where each point enters as P and phi(P).

Plain path: the TPU reference's rule, R = min(n/8, 2^14) and 4 subtasks a
launch (at 2^20: 4 x 16384 lanes, one wave of the scan kernel).

Pair-compressed path: the port's own rule, from the sweep of
``scripts/torch_compress_geometry.py`` on an H100 (``PERF.md``). Every
stage-3 kernel of the compressed path walks one serial chain per lane, so
the launch needs G x R lanes to fill the card, while the one Fermat
inversion per lane (kernel 9) grows with G x R: R = min(n/8,
``COMPRESS_ROWS``) lanes (C = n/R >= 8 steps, even, so no pair straddles two
lanes) and up to ``COMPRESS_BATCH`` subtasks a launch, halved while the
launch's pe3 buffer would exceed ``PE3_BYTES_MAX``.
"""

from __future__ import annotations

from dataclasses import dataclass

from msm_tpu_torch.params import MsmConfig

#: lanes of the compressed scan at most, and subtasks per compressed launch:
#: the sweep's fastest setting at both 2^16 and 2^20
COMPRESS_ROWS, COMPRESS_BATCH = 1 << 11, 16
#: the compressed launch's pe3 buffer at most (G x m/2 rows)
PE3_BYTES_MAX = 8 << 30


@dataclass(frozen=True)
class MsmGeometry:
    num_rows: int
    bpr_threads: int
    subtask_batch: int


def pe3_row_bytes(cfg: MsmConfig) -> int:
    """One pe3 row: x || y || z in 3 L int32 limbs of the config (BN254 at
    13-bit limbs: 240 B; the BLS12 curves': 360)."""
    return 3 * cfg.num_words * 4


def compressed_batch(m: int, cfg: MsmConfig) -> int:
    """Subtasks per compressed launch over a stream of m entries a subtask:
    COMPRESS_BATCH, halved while G x m/2 of the config's pe3 rows exceed
    PE3_BYTES_MAX (at least 1)."""
    batch = COMPRESS_BATCH
    while batch > 1 and batch * (m // 2) * pe3_row_bytes(cfg) > PE3_BYTES_MAX:
        batch //= 2
    return batch


def pick_geometry(n: int, cfg: MsmConfig) -> MsmGeometry:
    """The geometry of the config's path at n points (the padded point
    count, a power of two): its window width, whether it compresses and
    whether it splits by GLV. Under GLV the lanes stay the rule's for n
    points, as in the JAX package (so each lane walks twice the steps), and
    the compressed launch is sized by the 2n stream a subtask scans."""
    assert n & (n - 1) == 0 and n > 0
    body = 1 << (cfg.chunk_size - 1)
    bpr_threads = max(1, min(body // 16, 1 << 9))
    if cfg.compress:
        stream = 2 * n if cfg.glv else n
        return MsmGeometry(max(1, min(n // 8, COMPRESS_ROWS)), bpr_threads, compressed_batch(stream, cfg))
    return MsmGeometry(max(1, min(n // 8, 1 << 14)), bpr_threads, subtask_batch=4)
