"""The least time any MSM could take on one NVIDIA H100 SXM, from the
problem alone and never from the program's own work.

    t_min = max(ops_min / P, bytes_min / HBM)
    ops_min = 2 n * ceil(ceil(b / 2) / floor(log2 n)) * 6 * s^2
    bytes_min = n (8 s + 32)  bytes, each scalar set

b is the scalar field's bits and s the base field's 32-bit words. ops_min
is a deliberate lower bound on any MSM's 32-bit word products: a GLV-halved
scalar (2n half-scalars of ceil(b/2) bits), windows as wide as log2 n, one
batch-affine bucket addition of 6 products a half-scalar a window, and a
schoolbook product of s^2 word products with no reduction. bytes_min reads
each affine point (2 s words) and each 256-bit scalar once. The count is
for scalars uniform in [0, r): every window of every half-scalar holds a
nonzero digit but for a share of 2^-log2(n). Scalars with many zero digits
need less work, and a cell of such traffic needs a count of its own.
"""

from __future__ import annotations

import math

#: 132 SMs x 64 32-bit IMAD a clock x 1.98 GHz boost: the H100 SXM's
#: integer multiply-add issue rate (at its 700 W power limit)
IMAD_PER_S = 132 * 64 * 1.98e9
#: the H100 SXM's HBM3 bandwidth (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12


def msm_min(n: int, scalar_bits: int, base_bits: int) -> tuple[float, float, float]:
    """(ops_min, bytes_min, t_min seconds) of one MSM of n points."""
    s = math.ceil(base_bits / 32)
    windows = math.ceil(math.ceil(scalar_bits / 2) / int(math.log2(n)))
    ops = 2 * n * windows * 6 * s * s
    nbytes = n * (8 * s + 32)
    return ops, nbytes, max(ops / IMAD_PER_S, nbytes / HBM_BYTES_PER_S)
