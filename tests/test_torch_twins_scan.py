"""Plain twins of the scan and row-offsets kernels against the JAX
package's Pallas kernels in interpret mode (C = 4 steps, R = 512 lanes,
tile 256; row offsets over 512 lanes, 256 per block), on the same inputs.

The scan gets the same gathered points on both sides, so its prefixes and
lane totals compare coordinate by coordinate after canonical(); the row
offsets sum in another order than the kernel, so they compare as points."""

import jax.numpy as jnp
import numpy as np
import torch

from _torch_helpers import affine_points, canon, mont_limbs, port_cfg, same_points
from msm_tpu.ops.pallas_prefix import make_row_offsets
from msm_tpu.ops.pallas_scan import make_scan_rows
from msm_tpu.params import BN254, MsmConfig
from msm_tpu_torch.models.common import pad_points_words
from msm_tpu_torch.ops.cuda_convert import convert_pack
from msm_tpu_torch.ops.cuda_prefix import row_offsets
from msm_tpu_torch.ops.cuda_scan import scan_rows

JCFG = MsmConfig(curve=BN254)
CFG = port_cfg(JCFG)
L = CFG.num_words


def test_scan_twin_matches_pallas():
    C, R = 4, 512
    n = C * R
    aff = affine_points(CFG, 64, seed=5)
    x_u16, y_u16 = pad_points_words([aff[i % 64] for i in range(n)], CFG, n)
    packed = convert_pack(CFG, torch.from_numpy(x_u16), torch.from_numpy(y_u16)).numpy()
    rng = np.random.default_rng(0)
    perm = rng.permutation(n).astype(np.int32).reshape(C, R)  # step-major rows
    flags = rng.integers(0, 2, size=(C, R)).astype(np.int32)

    g = packed[perm]  # [C, R, 2D]
    pe_j, *tot_j = make_scan_rows(JCFG, C, R, tile=256, interpret=True)(
        jnp.asarray(g).swapaxes(1, 2), jnp.asarray(flags).reshape(C, 1, R)
    )
    pe_t, *tot_t = scan_rows(CFG, torch.from_numpy(packed),
                             torch.from_numpy(perm)[None], torch.from_numpy(flags)[None])
    pe_j, pe_t = np.asarray(pe_j), pe_t[0].numpy()
    for i in range(3):
        sl = slice(i * L, (i + 1) * L)
        assert np.array_equal(canon(pe_j[..., sl], CFG), canon(pe_t[..., sl], CFG))
    for a, b in zip(tot_j, tot_t):
        assert np.array_equal(canon(np.asarray(a).T, CFG), canon(b[0].numpy().T, CFG))


def test_row_offsets_twin_matches_pallas():
    R = 512
    aff = affine_points(CFG, 64, seed=3)
    pts = [aff[i % 64] for i in range(R)]
    xs = mont_limbs([x for x, _ in pts], CFG)
    ys = mont_limbs([y for _, y in pts], CFG)
    zs = mont_limbs([1] * R, CFG)
    zs[7], xs[7] = 0, 0  # an identity lane
    ys[7] = mont_limbs([1], CFG)[0]
    want = make_row_offsets(JCFG, R, lanes=256, interpret=True)(
        *(jnp.asarray(a.T) for a in (xs, ys, zs))
    )
    got = row_offsets(CFG, *(torch.from_numpy(np.ascontiguousarray(a.T))[None] for a in (xs, ys, zs)))
    assert same_points([np.asarray(w) for w in want], [g[0].numpy() for g in got], CFG)
