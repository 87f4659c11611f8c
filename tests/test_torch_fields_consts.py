"""Every constant of msm_tpu_torch/csrc/fields.cuh (the traits of the seven
fields the word core is generic over) against msm_tpu_torch.params: the
curve index, the word and limb counts, the REDC constants, 3b, the carry
flag, the reduction shifts, the launch bound's blocks per SM, and the
modulus, R mod p, R^2 mod p and the GLV convert's beta R^2 mod p (beta
from ops/glv.py's glv_params) word by word, in the 13-bit table and in
the 12-bit one (the library built with -DMSM_LIMB_BITS=12); and the
build's curve translation units, two per curve besides BN254."""

import re
from pathlib import Path

import pytest

from msm_tpu_torch.ops import _build
from msm_tpu_torch.ops.glv import glv_params
from msm_tpu_torch.params import CURVES, MsmConfig, coord_words

CSRC = Path(__file__).resolve().parent.parent / "msm_tpu_torch" / "csrc"


def _traits(width: int = 13) -> dict[str, dict]:
    """{curve name: {constant: value, "p"/"r"/"r2"/"beta_r2": [words]}}
    parsed from fields.cuh (struct FpXxx -> curve name xxx): the constants
    before the per-width tables and those of ``width``'s table (#if
    MSM_LIMB_BITS == width)."""
    text = (CSRC / "fields.cuh").read_text()
    out = {}
    for m in re.finditer(r"struct Fp(\w+) \{(.*?)\n\};", text, re.S):
        tables = dict(re.findall(r"#(?:el)?if MSM_LIMB_BITS == (\d+)[^\n]*\n(.*?)(?=#elif|#endif)", m.group(2), re.S))
        body = m.group(2).split("#if MSM_LIMB_BITS")[0] + tables[str(width)]
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
TRAITS12 = _traits(12)


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


@pytest.mark.parametrize("name", list(CURVES))
def test_width12_traits_match_params(name):
    """The 12-bit table of each traits type (the library built with
    -DMSM_LIMB_BITS=12) against MsmConfig(word_size=12): W and MASK, L and R
    = 2^(12 L), TAIL in [0, 32) (0 on BLS12-377: R = 2^(32 NW), no tail
    step, N0T unused and 0), N0T, BALANCED_TOP, R mod p, R^2 mod p and beta
    R^2 mod p; the constants that do not depend on the width are those of
    the 13-bit table's traits."""
    t, t13, cfg = TRAITS12[name], TRAITS[name], MsmConfig(curve=CURVES[name], word_size=12)
    p, nw, L = cfg.curve.modulus, t["NW"], t["L"]
    assert (t13["W"], t13["MASK"]) == (13, (1 << 13) - 1)
    assert (t["W"], t["MASK"]) == (12, (1 << 12) - 1) == (cfg.word_size, cfg.mask)
    for k in ("ID", "NW", "N0W", "B3", "CARRY", "REDUCE_TOP", "BLOCKS_PER_SM", "p"):
        assert t[k] == t13[k], k
    assert L == cfg.num_words and t["TAIL"] == 12 * L - 32 * nw and 0 <= t["TAIL"] < 32
    if t["TAIL"] > 0:
        assert t["N0T"] == (-pow(p, -1, 1 << t["TAIL"])) % (1 << t["TAIL"])
    else:
        assert name == "bls12_377" and t["N0T"] == 0
    bt = t["BALANCED_TOP"]
    assert p << bt < 1 << (12 * L) <= p << (bt + 1) and bt < 32

    def value(words):
        assert len(words) == nw
        return sum(w << (32 * i) for i, w in enumerate(words))

    assert value(t["r"]) == cfg.r == (1 << (12 * L)) % p
    assert value(t["r2"]) == cfg.r2
    assert value(t["beta_r2"]) == glv_params(cfg.curve).beta * cfg.r2 % p


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
