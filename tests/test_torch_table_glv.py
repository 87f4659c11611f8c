"""Carried state under GLV: the JAX package's triple point table (rows x,
beta x, y; make_convert_pack in triple mode) loaded into msm_tpu_torch with
load_point_table drives the port's compressed GLV pipeline to the JAX
package's window sums on the same points and scalars, and equals the
port's own GLV table bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_helpers import affine_points, port_cfg, same_points
import msm_tpu_torch
from msm_tpu.models import common as jcommon
from msm_tpu.models import cuzk as jcuzk
from msm_tpu.models.geometry import pick_geometry as j_pick_geometry
from msm_tpu.ops.curve import get_curve_ctx as j_curve_ctx
from msm_tpu.ops.glv import glv_params
from msm_tpu.ops.pallas_convert import make_convert_pack
from msm_tpu.params import BN254, MsmConfig
from msm_tpu_torch.models import common, cuzk
from msm_tpu_torch.models.geometry import pick_geometry

JGLV = MsmConfig(curve=BN254, chunk_size=8, compress=True, glv=True)
GLV = port_cfg(JGLV)


def test_loaded_jax_triple_table_gives_jax_window_sums_glv():
    """compress x glv, at chunk 8 (S = 16 windows of 512 entries)."""
    n = 256
    base = affine_points(GLV, 32, seed=62)
    pts = [base[i % 32] for i in range(n)]
    rng = np.random.default_rng(62)
    ks = [int.from_bytes(rng.bytes(32), "little") % BN254.order for _ in range(n)]
    x_u16, y_u16, s_u16 = jcommon.pad_inputs(pts, ks, JGLV)
    xd, yd, sd = map(jnp.asarray, (x_u16, y_u16, s_u16))
    beta_r2 = glv_params(BN254).beta * JGLV.r2 % BN254.modulus
    jax_table = np.asarray(make_convert_pack(JGLV, tile=128, interpret=True, dual_x_scale_int=beta_r2,
                                             triple=True)(xd, yd))
    table = msm_tpu_torch.load_point_table(jax_table, GLV, device="cpu")
    geom = pick_geometry(n, GLV)
    ws = cuzk.window_sums_from_table(table, torch.from_numpy(s_u16), GLV, geom)
    assert ws.shape[0] == GLV.num_subtasks == 16

    jec = j_curve_ctx(JGLV)
    jgeom = j_pick_geometry(n, 8, compress=True)
    want = np.asarray(jax.jit(lambda x, y, s: jcuzk.window_sums_from_table(
        *jcommon.prepare_points(jec, x, y, jgeom.num_rows), s, JGLV, jgeom))(xd, yd, sd))
    assert same_points([want[:, i] for i in range(3)], [ws[:, i].numpy() for i in range(3)], GLV)
    own = common.prepare_points(GLV, torch.from_numpy(x_u16), torch.from_numpy(y_u16))
    assert np.array_equal(own.numpy(), jax_table)
