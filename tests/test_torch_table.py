"""Carried state: the point table the JAX package prepares
(make_convert_pack output) loaded into msm_tpu_torch with load_point_table
drives the port's scalar-side pipeline to the same window sums as the JAX
package's window_sums_from_table on the same points and scalars (under a
GLV config: test_torch_table_glv.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import affine_points, port_cfg, same_points
import msm_tpu_torch
from msm_tpu.models import common as jcommon
from msm_tpu.models import cuzk as jcuzk
from msm_tpu.models.geometry import pick_geometry as j_pick_geometry
from msm_tpu.ops.curve import get_curve_ctx as j_curve_ctx
from msm_tpu.ops.pallas_convert import make_convert_pack
from msm_tpu.params import BN254, MsmConfig
from msm_tpu_torch.models import common, cuzk
from msm_tpu_torch.models.geometry import pick_geometry

JCFG = MsmConfig(curve=BN254, chunk_size=8)
CFG = port_cfg(JCFG)
JGLV = MsmConfig(curve=BN254, chunk_size=8, compress=True, glv=True)
GLV = port_cfg(JGLV)


def test_loaded_jax_table_gives_jax_window_sums():
    n = 256
    base = affine_points(CFG, 32, seed=61)
    pts = [base[i % 32] for i in range(n)]
    rng = np.random.default_rng(61)
    ks = [int.from_bytes(rng.bytes(32), "little") % BN254.order for _ in range(n)]
    x_u16, y_u16, s_u16 = jcommon.pad_inputs(pts, ks, JCFG)
    xd, yd, sd = map(jnp.asarray, (x_u16, y_u16, s_u16))

    jax_table = np.asarray(make_convert_pack(JCFG, tile=128, interpret=True)(xd, yd))
    table = msm_tpu_torch.load_point_table(jax_table, CFG, device="cpu")
    ws = cuzk.window_sums_from_table(table, torch.from_numpy(s_u16), CFG, pick_geometry(n, CFG))

    jec = j_curve_ctx(JCFG)
    jgeom = j_pick_geometry(n, 8)
    want = jax.jit(lambda x, y, s: jcuzk.window_sums_from_table(
        jcommon.u16_to_mont_points(jec, x, y), None, s, JCFG, jgeom))(xd, yd, sd)
    want = np.asarray(want)
    assert same_points([want[:, i] for i in range(3)], [ws[:, i].numpy() for i in range(3)], CFG)
    # and the port's own table is the JAX table, bit for bit
    own = common.prepare_points(CFG, torch.from_numpy(x_u16), torch.from_numpy(y_u16))
    assert np.array_equal(own.numpy(), jax_table)


def test_load_point_table_rejects_bad_shape():
    with pytest.raises(ValueError):
        msm_tpu_torch.load_point_table(np.zeros((4, 15), np.int32), CFG, device="cpu")
    with pytest.raises(ValueError):  # a plain table under a GLV config
        msm_tpu_torch.load_point_table(np.zeros((4, 16), np.int32), GLV, device="cpu")
