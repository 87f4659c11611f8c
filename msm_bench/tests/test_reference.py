"""The reference and the point generator, held to the naive MSM at small n."""

import numpy as np
import pytest

from msm_bench import points, reference, traffic
from helpers import MIXED, tiny_conf

CONFS = ["bn254_groth16_2p20", "bls12_377_zprize_2p22"]


@pytest.mark.parametrize("name", CONFS)
def test_points_lie_on_the_curve_are_distinct_and_are_their_logs(name):
    ps = points.PointSet.from_config(tiny_conf(name, log_n=7))
    pts = points.make(ps)
    pairs = points.as_tuples(ps, pts)
    assert len(set(pairs)) == ps.n
    assert all(ps.curve.on_curve(x, y) for x, y in pairs)
    assert len({x for x, _ in pairs}) == ps.n  # no two opposite points either
    points.check(ps, pts, range(ps.n))


def test_workers_give_the_same_points():
    ps = points.PointSet.from_config(tiny_conf(CONFS[0], log_n=6))
    assert np.array_equal(points.make(ps, workers=1), points.make(ps, workers=3))


def test_cache_is_written_once_and_checked(tmp_path):
    ps = points.PointSet.from_config(tiny_conf(CONFS[0], log_n=5))
    first = points.load(ps, tmp_path)
    path = tmp_path / f"{ps.key}.bin"
    stamp = path.stat().st_mtime_ns
    assert np.array_equal(points.load(ps, tmp_path), first) and path.stat().st_mtime_ns == stamp
    raw = bytearray(path.read_bytes())
    raw[5] ^= 1
    path.write_bytes(bytes(raw))  # a damaged file fails its hash and is made again
    assert np.array_equal(points.load(ps, tmp_path), first)


@pytest.mark.parametrize("name", CONFS)
@pytest.mark.parametrize("kind", ["uniform", "mixed"])
def test_msm_of_words_is_the_naive_msm(name, kind):
    ps = points.PointSet.from_config(tiny_conf(name, log_n=5))
    pairs = points.as_tuples(ps, points.make(ps))
    mixes = {"uniform": [{"share": 1.0, "kind": "uniform"}], "mixed": MIXED}
    words = traffic.make_vector(np.random.default_rng(3), mixes[kind], ps.n, ps.curve.r, 16)
    words[0] = np.frombuffer((ps.curve.r - 1).to_bytes(32, "little"), "<u2")
    ks = reference.words_to_ints(words)
    want = reference.msm_direct(ps.curve, pairs, ks)
    assert reference.msm_of_words(ps.curve, words, ps.a, ps.d, ps.perm) == want
    low = reference.control_words(words)
    assert reference.msm_of_words(ps.curve, low, ps.a, ps.d, ps.perm) == reference.msm_direct(
        ps.curve, pairs, reference.words_to_ints(low))
    assert reference.msm_of_words(ps.curve, low, ps.a, ps.d, ps.perm) != want


def test_traffic_counts_are_exact_and_scalars_below_the_order():
    r = int(tiny_conf(CONFS[0])["curve"]["order"])
    mix = MIXED
    for seed in (1, 2**31 + 5):
        ks = reference.words_to_ints(traffic.make_vector(np.random.default_rng(seed), mix, 1000, r, 16))
        assert sum(k == 0 for k in ks) >= 400 and sum(k == 1 for k in ks) >= 300
        assert sum(2 <= k < 2**32 for k in ks) >= 100 and all(0 <= k < r for k in ks)
    a = traffic.make_pool({"batch": 1, "pool": 8, "mix": mix}, 64, r, 9)
    b = traffic.make_pool({"batch": 1, "pool": 8, "mix": mix}, 64, r, 9)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_traffic_refuses_a_malformed_file():
    with pytest.raises(ValueError):
        traffic.check({"batch": 4, "pool": 6, "mix": [{"share": 1.0, "kind": "uniform"}]})
    with pytest.raises(ValueError):
        traffic.check({"batch": 1, "pool": 8, "mix": [{"share": 0.5, "kind": "uniform"}]})
