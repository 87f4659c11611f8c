"""msm_tpu_torch.parallel.sharded on the CPU (every kernel replaced by its
plain twin; D shards on ``[torch.device("cpu")] * D``) against the JAX
package's ``msm_tpu.parallel.sharded`` over its 8 virtual CPU devices,
with tests/test_sharded.py's config, inputs and seeds: the point-add tree
against ``_tree_add_points``, and the window sums at D = 4 against JAX's
``sharded_window_sums`` (its program the one test_sharded.py compiles: the
same shapes and input sharding). The MSMs: test_torch_sharded_msm.py."""

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
import numpy as np
import pytest
import torch

from _torch_helpers import affine_points, canon, mont_limbs, port_cfg, same_points
from msm_tpu.models import common as jcommon
from msm_tpu.models.geometry import pick_geometry as jpick_geometry
from msm_tpu.ops.curve import get_curve_ctx as jget_curve_ctx
from msm_tpu.params import BN254 as JBN254
from msm_tpu.params import MsmConfig as JMsmConfig
from msm_tpu.parallel import default_mesh as jdefault_mesh
from msm_tpu.parallel import sharded_window_sums as jsharded_window_sums
from msm_tpu.parallel.sharded import _tree_add_points
from msm_tpu_torch.models import common
from msm_tpu_torch.models.geometry import MsmGeometry
from msm_tpu_torch.oracle.pyecc import Curve
from msm_tpu_torch.ops import cuda_curve
from msm_tpu_torch.ops.curve import PointBatch, get_curve_ctx
from msm_tpu_torch.parallel import sharded_window_sums
from msm_tpu_torch.parallel.sharded import tree_add_points

JCFG = JMsmConfig(curve=JBN254, chunk_size=8)
CFG = port_cfg(JCFG)
CV = Curve(CFG.curve)
#: every subtask in one batch: the CPU twins' serial steps run once for all
#: 32 windows (the default geometry: test_torch_sharded_msm.py at D = 4)
WIDE = MsmGeometry(num_rows=8, bpr_threads=8, subtask_batch=CFG.num_subtasks)


def _sample(n, seed=0):
    pts = [CV.to_affine(p) for p in CV.sample_points(n, seed=seed)]
    return pts, CV.sample_scalars(n, seed=seed + 1)


def _cpus(d):
    return [torch.device("cpu")] * d


def _stack(d: int, windows: int, seed: int) -> np.ndarray:
    """[d, windows, 3, L] Montgomery limbs of real points (X : Y : Z) =
    (lx, ly, l) for random l; shard 0's window 0 is the identity, shard 1
    repeats shard 0's window 1 (a doubling) and negates its window 2 (a
    sum at infinity)."""
    p = CFG.curve.modulus
    rng = np.random.default_rng(seed)
    pts = affine_points(CFG, d * windows, seed)
    lam = [int(v) + 1 for v in rng.integers(1, 1 << 62, size=d * windows)]
    xyz = [[x * l % p, y * l % p, l] for (x, y), l in zip(pts, lam)]
    xyz[0] = [0, 1, 0]
    if d > 1:
        xyz[windows + 1] = xyz[1]
        xyz[windows + 2] = [xyz[2][0], p - xyz[2][1], xyz[2][2]]
    limbs = np.stack([mont_limbs([c[i] for c in xyz], CFG) for i in range(3)], axis=1)
    return limbs.reshape(d, windows, 3, CFG.num_words)


TREE_DS = (2, 3, 4, 8)


@pytest.fixture(scope="module")
def jax_trees():
    """The stacks of test_tree_matches_jax_tree and JAX's trees over them,
    all four in one jitted program (one compile)."""
    stacks = [_stack(d, 4, seed=40 + d) for d in TREE_DS]
    ec = jget_curve_ctx(JCFG)
    trees = jax.jit(lambda ss: [_tree_add_points(ec, st) for st in ss])([jnp.asarray(st) for st in stacks])
    return {d: (st, np.asarray(t)) for d, st, t in zip(TREE_DS, stacks, trees)}


@pytest.mark.parametrize("d", TREE_DS)
def test_tree_matches_jax_tree(d, jax_trees, monkeypatch):
    """The same pairing and formula as the JAX package's tree: equal
    coordinates after canonicalization; d - 1 additions a window in
    ceil(log2 d) point-add calls."""
    stacked, want = jax_trees[d]
    calls = []
    add = cuda_curve.point_add
    monkeypatch.setattr(cuda_curve, "point_add", lambda cfg, *c: calls.append(c[0].shape[0]) or add(cfg, *c))
    got = tree_add_points(get_curve_ctx(CFG), torch.from_numpy(stacked)).numpy()
    assert got.shape == want.shape == (4, 3, CFG.num_words)
    assert np.array_equal(canon(got, CFG), canon(want, CFG))
    assert len(calls) == (d - 1).bit_length() and sum(calls) == 4 * (d - 1)


def test_tree_of_one_shard_is_its_input():
    stacked = torch.from_numpy(_stack(1, 3, seed=49))
    assert torch.equal(tree_add_points(get_curve_ctx(CFG), stacked), stacked[0])


@pytest.fixture(scope="module")
def inputs100():
    """tests/test_sharded.py::test_sharded_matches_single_chip's inputs."""
    return _sample(100, seed=7)


def test_window_sums_match_jax(inputs100):
    """D = 4 on the same u16 inputs (128 rows, 32 a shard): the port's
    window sums equal JAX's window by window as points."""
    pts, ks = inputs100
    jx, jy, js = jcommon.pad_inputs(pts, ks, JCFG, multiple=64)
    jgeom = jpick_geometry(jx.shape[0] // 4, JCFG.chunk_size)
    mesh = jdefault_mesh(jax.devices()[:4])
    sharding = NamedSharding(mesh, P("data", None))
    want = np.asarray(jsharded_window_sums(*(jax.device_put(jnp.asarray(a), sharding) for a in (jx, jy, js)),
                                           JCFG, jgeom, mesh, "data"))
    arrays = common.pad_inputs(pts, ks, CFG, multiple=64)
    assert all(np.array_equal(a.view(np.uint16) if a.dtype == np.int16 else a, b)
               for a, b in zip(arrays, (jx, jy, js)))
    ws = sharded_window_sums(*arrays, CFG, WIDE, _cpus(4))
    got = common.export_points_std(get_curve_ctx(CFG), PointBatch(*ws.unbind(1))).numpy()
    assert got.shape == want.shape
    for s in range(want.shape[0]):
        assert same_points(got[s], want[s], CFG), s
