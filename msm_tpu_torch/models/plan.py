"""The serving plan: prepare the point table once, run many scalar sets —
the PyTorch port of ``msm_tpu/models/plan.py``.

Provers fix the point set (the SRS) across many MSMs while only the
scalars change. A plan pays the points' serialization, upload and
conversion (kernel 2) once and keeps the table on the device:

    plan = msm_tpu_torch.plan(points)     # serialize, upload, convert
    res1 = plan(scalars_1)                # per call: the scalar side only
    res2 = plan(words)                    # scalars as u16 words [n, 16]
    many = plan.run_batch([ks_a, ks_b])   # B sets, one upload, one copy back

A call ships only the scalars, packed two u16 words to an int32 (32 B a
scalar) from a pinned host buffer that the plan owns, and runs the port's
``compute_msm_jpoint`` after the table: decompose (under GLV the split
first), stages 2-4 (``cuzk.window_sums_from_table``), the Horner kernel and
one copy of its rows to the host (``cuzk.msm_jpoints_from_ws``, which takes
a batch's ladders in one launch). Scalars come as ints (serialized and
reduced mod the order, as ``pad_inputs`` does) or as a word array, taken as
it is (the caller guarantees k < order), which skips the Python-int
serialization.

Every call has ``compute_msm``'s geometry and chunks: up to
``cuzk.CHUNK_MAX`` points one table and one pass; above it one table per
chunk of ``CHUNK_MAX`` points, as the JAX plan keeps them. A call then runs
each chunk's scalar rows (uploaded chunk by chunk from the one pinned
buffer) against its table, adds the chunks' window sums on the device
(``cuzk.merge_window_sums``: the point-add tree, one launch a level), and
ends in the same single Horner launch over the B ladders and
one copy back. The JAX plan's 2^20 slicing is not ported (a TPU VMEM rule
that computes the same function). A wrong scalar count raises
``ValueError`` (the JAX package asserts).
"""

from __future__ import annotations

import numpy as np
import torch

from msm_tpu_torch.models import common, cuzk
from msm_tpu_torch.models.geometry import MsmGeometry, pick_geometry
from msm_tpu_torch.oracle.pyecc import JPoint
from msm_tpu_torch.params import MsmConfig, pick_config


def _word_count(cfg: MsmConfig) -> int:
    """u16 words per serialized scalar (16 for a 256-bit order)."""
    return (cfg.scalar_bits + 7) // 8 // 2


def _check_words(words: np.ndarray, cfg: MsmConfig, n: int, N: int) -> None:
    W = _word_count(cfg)
    if words.ndim != 2 or words.shape[1] != W:
        raise ValueError(f"expected scalar words [n, {W}], got {words.shape}")
    if words.shape[0] not in (n, N):
        raise ValueError(f"expected {n} (or padded {N}) scalars, got {words.shape[0]}")


def scalars_to_words(scalars, cfg: MsmConfig, n: int, N: int) -> np.ndarray:
    """Scalars -> padded u16 words int32 [N, W]: a list of n ints is
    serialized with ``pad_scalars_words``'s reduction mod the order; a word
    array [n, W] or [N, W] (any integer dtype, little-endian u16 values,
    k < order guaranteed by the caller) is copied as it is into the first
    rows."""
    if isinstance(scalars, np.ndarray):
        _check_words(scalars, cfg, n, N)
        out = np.zeros((N, _word_count(cfg)), np.int32)
        out[: scalars.shape[0]] = scalars
        return out
    if len(scalars) != n:
        raise ValueError(f"plan built over {n} points, got {len(scalars)} scalars")
    return common.pad_scalars_words(list(scalars), cfg, N)


class MsmPlan:
    """A reusable MSM over a fixed point set. Build with
    ``msm_tpu_torch.plan``; ``device="cpu"`` runs the kernels' plain twins.
    Calls must not overlap: they share the plan's host buffer."""

    def __init__(
        self,
        points: list[tuple[int, int]],
        config: MsmConfig | None = None,
        geometry: MsmGeometry | None = None,
        validate: bool = False,
        device="cuda",
    ):
        words = self._setup(points, config, validate, device, 1)
        #: the chunks' rows, and each chunk's point table on the device
        self.slices = cuzk.chunk_slices(self.N)
        self.geom = geometry or pick_geometry(self.slices[0].stop, self.cfg)
        self.tables = [common.prepare_points(self.cfg, xd, yd) for xd, yd in cuzk.chunks(words, self.device)]

    def _setup(self, points, config, validate: bool, device, shards: int) -> tuple[np.ndarray, np.ndarray]:
        """What every plan holds: the config, n and the padded N (a power
        of two of at least 16 rows a shard), the device of the uploads, the
        pinned buffer. Returns the points' padded coordinate words."""
        n = len(points)
        if n == 0:
            raise ValueError("a plan needs a non-empty point set")
        self.cfg = config or pick_config(n)
        common.check_config(self.cfg, device)
        if validate:
            common.validate_inputs(points, self.cfg, device)
        self.n, self.N = n, common.pad_size(max(n, 16 * shards))
        self.device = torch.device(device)
        # slot b of [B, N, W/2] packed scalar words; rows from _filled[b] on
        # are zero (the padding's scalars)
        self._staging = common.staging_buffer((1, self.N, _word_count(self.cfg) // 2), self.device)
        self._filled = [0]
        return common.pad_points_words(points, self.cfg, self.N)

    def _stage(self, slot: int, scalars) -> None:
        """Pack one scalar set into slot ``slot`` of the host buffer. The
        buffer is read by an upload that a later call of this plan never
        overtakes: each call ends in a copy to the host, which waits for
        the stream."""
        if isinstance(scalars, np.ndarray):
            _check_words(scalars, self.cfg, self.n, self.N)
        else:
            scalars = scalars_to_words(scalars, self.cfg, self.n, self.N)
        pairs = common.pack_scalar_words(scalars)
        rows = pairs.shape[0]
        buf = self._staging[slot].numpy()
        buf[:rows] = pairs
        if rows < self._filled[slot]:
            buf[rows : self._filled[slot]] = 0
        self._filled[slot] = rows

    def _upload(self, slot: int, rows: slice) -> torch.Tensor:
        """Rows ``rows`` of slot ``slot``, packed [rows, W/2], on the
        device."""
        return self._staging[slot, rows].to(self.device, non_blocking=True)

    def window_sums(self, rows_of) -> torch.Tensor:
        """One scalar set's Montgomery window sums [S, 3, L]: ``rows_of``
        gives a chunk's scalar words on the device (``rows -> [rows, W]``),
        each chunk runs against its table, and the chunks' sums are merged
        on the device."""
        return cuzk.merge_window_sums(
            (cuzk.window_sums_from_table(t, rows_of(s), self.cfg, self.geom) for t, s in zip(self.tables, self.slices)),
            self.cfg)

    def jpoint(self, scalars) -> JPoint:
        """Run the plan over one scalar set (n ints, or words [n or N, W])
        -> oracle JPoint."""
        return self.run_batch([scalars])[0]

    def __call__(self, scalars) -> tuple[int, int] | None:
        """Run the plan -> affine (x, y), or None for the identity."""
        return common.result_to_affine(self.jpoint(scalars), self.cfg)

    def run_batch(self, scalar_sets) -> list[JPoint]:
        """B scalar sets on the plan's tables: each set's rows uploaded
        chunk by chunk from the pinned buffer, the instances back to back on
        the device (only each one's [S, 3, L] window sums kept), one Horner
        launch over the B ladders, one copy of the B results to the host."""
        B = len(scalar_sets)
        if B == 0:
            return []
        if B > self._staging.shape[0]:
            self._staging = common.staging_buffer((B, *self._staging.shape[1:]), self.device)
            self._filled = [0] * B
        for b, scalars in enumerate(scalar_sets):
            self._stage(b, scalars)
        return cuzk.msm_jpoints_from_ws(
            [self.window_sums(lambda rows, b=b: common.unpack_scalar_words(self._upload(b, rows))) for b in range(B)],
            self.cfg)

