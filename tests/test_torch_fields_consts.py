"""Every constant of msm_tpu_torch/csrc/fields.cuh (the traits of the seven
fields the word core is generic over) against msm_tpu_torch.params: the
curve index, the word and limb counts, the REDC constants, 3b, the carry
flag, the reduction shifts, the launch bound's blocks per SM, and the
modulus, R mod p, R^2 mod p and the GLV convert's beta R^2 mod p (beta
from ops/glv.py's glv_params) word by word; and the build's curve
translation units, two per curve besides BN254."""

import re
from pathlib import Path

import pytest

from msm_tpu_torch.ops import _build
from msm_tpu_torch.ops.glv import glv_params
from msm_tpu_torch.params import CURVES, MsmConfig, coord_words

CSRC = Path(__file__).resolve().parent.parent / "msm_tpu_torch" / "csrc"


def _traits() -> dict[str, dict]:
    """{curve name: {constant: value, "p"/"r"/"r2": [words]}} parsed from
    fields.cuh (struct FpXxx -> curve name xxx)."""
    text = (CSRC / "fields.cuh").read_text()
    out = {}
    for m in re.finditer(r"struct Fp(\w+) \{(.*?)\n\};", text, re.S):
        body = m.group(2)
        consts = {k: v for k, v in re.findall(r"(\b[A-Z][A-Z0-9_]*) = ([^,;]+)", body)}
        vals = {}
        for k, v in consts.items():
            v = v.strip().rstrip("u")
            vals[k] = {"true": True, "false": False}.get(v, None)
            if vals[k] is None and not v.startswith("MSM_"):  # a build define stays its name
                vals[k] = int(v, 16) if v.startswith("0x") else int(v)
            elif vals[k] is None:
                vals[k] = v
        for arr in ("p", "r", "r2", "beta_r2"):
            words = re.search(rf"static uint32_t {arr}\(int i\) \{{\s*const uint32_t t\[NW\] = \{{(.*?)\}};",
                              body, re.S).group(1)
            vals[arr] = [int(w.strip().rstrip("u"), 16) for w in words.split(",")]
        out[m.group(1).lower()] = vals
    return out


TRAITS = _traits()


def test_every_curve_has_traits():
    assert sorted(TRAITS) == sorted(CURVES)


@pytest.mark.parametrize("name", list(CURVES))
def test_traits_match_params(name):
    t, cfg = TRAITS[name], MsmConfig(curve=CURVES[name])
    p, nw, L = cfg.curve.modulus, t["NW"], t["L"]
    assert t["ID"] == list(CURVES).index(name) == _build.curve_id(cfg)
    assert nw == coord_words(cfg) == (cfg.curve.modulus_bits + 31) // 32
    assert L == cfg.num_words and t["TAIL"] == 13 * L - 32 * nw and 0 < t["TAIL"] < 32
    assert t["N0W"] == (-pow(p, -1, 1 << 32)) % (1 << 32)
    assert t["N0T"] == (-pow(p, -1, 1 << t["TAIL"])) % (1 << t["TAIL"])
    assert t["B3"] % p == 3 * cfg.curve.b % p and 0 < abs(t["B3"]) < 1 << 16
    top = p >> (32 * (nw - 1))
    assert t["CARRY"] == (2 * p >= 1 << (32 * nw) or top > (1 << 31) - 2)
    rt, bt = t["REDUCE_TOP"], t["BALANCED_TOP"]
    assert p << rt < 1 << (32 * nw) <= p << (rt + 1)
    assert p << bt < 1 << (13 * L) <= p << (bt + 1) and bt < 32
    # the launch bound's blocks per SM: the build's one table, by word count
    assert t["BLOCKS_PER_SM"] == f"MSM_BLOCKS_NW{nw}"
    assert f"-DMSM_BLOCKS_NW{nw}={_build.WORD_BLOCKS_PER_SM[nw]}" in _build.NVCC_FLAGS
    assert _build.word_threads_per_sm(cfg) == 128 * _build.WORD_BLOCKS_PER_SM[nw]

    def value(words):
        assert len(words) == nw
        return sum(w << (32 * i) for i, w in enumerate(words))

    assert value(t["p"]) == p
    assert value(t["r"]) == cfg.r == (1 << (13 * L)) % p
    assert value(t["r2"]) == cfg.r2
    # the GLV convert's constant: a product by it takes x to beta x R
    beta = glv_params(cfg.curve).beta
    assert value(t["beta_r2"]) == beta * cfg.r2 % p and pow(beta, 3, p) == 1 != beta


def test_each_other_curve_has_a_translation_unit():
    """Two translation units per curve besides BN254: csrc/curve_<name>.cu
    instantiating its plain kernels and the GLV modes of the convert and the
    scan, csrc/curve_<name>_pairs.cu its pair kernels (9-13), BPR phase 1
    (8) and the scaled convert; the dispatch switch names every traits
    type."""
    dispatch = (CSRC / "dispatch.cuh").read_text()
    for name in CURVES:
        struct = next(f"Fp{k}" for k in re.findall(r"struct Fp(\w+) \{", (CSRC / "fields.cuh").read_text())
                      if k.lower() == name)
        assert f"msm::{struct}::ID" in dispatch
        if name != "bn254":
            unit = (CSRC / f"curve_{name}.cu").read_text()
            assert f"MSM_INSTANTIATE_PLAIN(msm::{struct})" in unit
            assert f"MSM_INSTANTIATE_GLV(msm::{struct})" in unit
            pairs = (CSRC / f"curve_{name}_pairs.cu").read_text()
            assert f"MSM_INSTANTIATE_PAIRS(msm::{struct})" in pairs
            assert f"MSM_INSTANTIATE_OFFPATH(msm::{struct})" in pairs
