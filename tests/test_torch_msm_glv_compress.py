"""The pair-compressed GLV slice on the CPU (``MsmConfig(compress=True,
glv=True)``, every kernel replaced by its plain twin) against the JAX
package's compute_msm_jpoint (its XLA pipeline on the CPU) and the oracle,
at n = 2^12, chunk 8, R = 256 lanes: the feature set the JAX package's
tests call the production 2^20 configuration's. Also the geometry rule
under GLV: the compressed launch is sized by the 2n-entry stream."""

from _torch_helpers import port_cfg, tiled_msm_inputs
from msm_tpu.models.cuzk import compute_msm_jpoint as j_compute_msm_jpoint
from msm_tpu.models.geometry import MsmGeometry as JGeometry
from msm_tpu.oracle.pyecc import Curve as JCurve
from msm_tpu.params import BN254, MsmConfig
from msm_tpu_torch.models import geometry
from msm_tpu_torch.models.cuzk import compute_msm_jpoint
from msm_tpu_torch.models.geometry import MsmGeometry
from msm_tpu_torch.oracle import best_msm
from msm_tpu_torch.oracle.pyecc import Curve


def test_compressed_glv_slice_matches_jax_and_oracle():
    jcfg = MsmConfig(curve=BN254, chunk_size=8, compress=True, glv=True)
    cfg = port_cfg(jcfg)
    pts, ks = tiled_msm_inputs(cfg, 1 << 12, seed=7)
    got = compute_msm_jpoint(pts, ks, config=cfg, geometry=MsmGeometry(256, 64, 4), device="cpu")
    cv = Curve(cfg.curve)
    assert cv.eq(got, best_msm(pts, ks))
    want = j_compute_msm_jpoint(pts, ks, config=jcfg, geometry=JGeometry(256, 64, 4))
    assert cv.to_affine(got) == JCurve(jcfg.curve).to_affine(want)


def test_compressed_geometry_sized_by_glv_stream():
    """Under GLV a subtask scans 2n entries (n pairs): the pe3 bound halves
    the subtasks a launch one size earlier; the lanes stay the rule's."""
    comp = port_cfg(MsmConfig(curve=BN254, compress=True))
    comp_glv = port_cfg(MsmConfig(curve=BN254, compress=True, glv=True))
    for n in (1 << 16, 1 << 20, 1 << 21, 1 << 22):
        plain = geometry.pick_geometry(n, comp)
        glv = geometry.pick_geometry(n, comp_glv)
        assert glv.num_rows == plain.num_rows
        assert glv.subtask_batch == geometry.compressed_batch(2 * n, comp_glv)
        assert glv.subtask_batch * n * geometry.pe3_row_bytes(comp_glv) <= geometry.PE3_BYTES_MAX
    assert geometry.pe3_row_bytes(comp_glv) == 3 * 20 * 4  # BN254's 20 limbs
    assert geometry.pick_geometry(1 << 20, comp_glv).subtask_batch == 16
    assert geometry.pick_geometry(1 << 22, comp_glv).subtask_batch == 8
    assert geometry.pick_geometry(1 << 22, comp).subtask_batch == 16
