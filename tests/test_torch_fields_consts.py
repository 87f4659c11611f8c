"""Every constant of msm_tpu_torch/csrc/fields.cuh (the traits of the seven
fields the word core is generic over) against msm_tpu_torch.params: the
curve index, the word and limb counts, the REDC constants, 3b, the carry
flag, the reduction shifts, the launch bound's blocks per SM, and the
modulus, R mod p, R^2 mod p and the GLV convert's beta R^2 mod p (beta
from ops/glv.py's glv_params) word by word, in the 13-bit table (the
default library's compile-time constants); every row of csrc/widths.cuh,
the narrow library's run-time width blocks (curve x width 8 to 13),
against MsmConfig at that width, and the file against its generator
(scripts/torch_gen_widths.py); and the build's curve translation units,
four per curve besides BN254."""

import importlib.util
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
        tables = dict(re.findall(r"#(?:el)?if MSM_LIMB_BITS == (\d+)[^\n]*\n(.*?)(?=#elif|#else|#endif)", m.group(2),
                                 re.S))
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
ROOT = CSRC.parent.parent
NARROW = (8, 9, 10, 11, 12, 13)


def _width_blocks() -> dict[tuple[str, int], dict]:
    """{(curve name, width): row} parsed from csrc/widths.cuh's
    WIDTH_BLOCKS (rows in params.CURVES order, widths 8 .. 13); a row's
    fields as the WidthBlock struct orders them, the word arrays as lists."""
    text = (CSRC / "widths.cuh").read_text()
    fields = re.search(r"struct WidthBlock \{(.*?)\};", text, re.S).group(1)
    names = re.findall(r"(\w+)(?:\[\d+\])?[,;]", fields)
    table = text.split("WIDTH_BLOCKS", 2)[2]
    out = {}
    for name, body in re.findall(r"\{\s*// (\w+)\n(.*?)\n    \},", table, re.S):
        for i, row in enumerate(re.findall(r"\{(\d+, .*?\})\}", body, re.S)):
            items = re.findall(r"\{([^{}]*)\}|(0x[0-9a-f]+u|-?\d+)", row)
            vals = [[int(v.strip().rstrip("u"), 0) for v in arr.split(",")] if arr else int(one.rstrip("u"), 0)
                    for arr, one in items]
            out[(name, NARROW[i])] = dict(zip(names, vals))
    return out


BLOCKS = _width_blocks()
#: the 12-bit rows in the form of TRAITS (the narrow library's width 12)
TRAITS12 = {name: {**{k: v for k, v in TRAITS[name].items() if k not in ("W", "L", "TAIL", "N0T", "MASK",
                                                                          "BALANCED_TOP", "r", "r2", "beta_r2")},
                   **{k: (v[:TRAITS[name]["NW"]] if isinstance(v, list) else v)
                      for k, v in BLOCKS[(name, 12)].items()}}
            for name in CURVES}


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
    """The 12-bit row of each curve in csrc/widths.cuh (the narrow library,
    -DMSM_LIMB_BITS=0, at width 12) against MsmConfig(word_size=12): W and MASK, L and R
    = 2^(12 L), TAIL in [0, 32) (0 on BLS12-377: R = 2^(32 NW), no tail
    step, N0T unused and 0), N0T, BALANCED_TOP, R mod p, R^2 mod p and beta
    R^2 mod p; the constants that do not depend on the width are those of
    the 13-bit table's traits, and the fields.cuh traits hold no 12-bit
    table of their own."""
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
    assert "MSM_LIMB_BITS == 12" not in (CSRC / "fields.cuh").read_text()


@pytest.mark.parametrize("width", NARROW)
@pytest.mark.parametrize("name", list(CURVES))
def test_width_blocks_match_params(name, width):
    """Every run-time width block (csrc/widths.cuh, curve x width 8 to 13)
    against MsmConfig(word_size=width): W, MASK, L with R = 2^(W L), TAIL =
    W L - 32 NW in [0, 32) and N0T = -p^-1 mod 2^TAIL (0 at TAIL 0),
    BALANCED_TOP the largest s with p 2^s < R, PE3_ROW 3 L rounded up to 4,
    and R, R^2 and beta R^2 mod p word by word (zero above NW). The
    row at 13 equals the default library's compile-time 13-bit constants."""
    b, cfg = BLOCKS[(name, width)], MsmConfig(curve=CURVES[name], word_size=width)
    p, nw, L = cfg.curve.modulus, coord_words(cfg), cfg.num_words
    assert (b["W"], b["MASK"], b["L"]) == (width, (1 << width) - 1, L) == (cfg.word_size, cfg.mask, cfg.num_words)
    tail = b["TAIL"]
    assert tail == width * L - 32 * nw and 0 <= tail < 32
    assert b["N0T"] == ((-pow(p, -1, 1 << tail)) % (1 << tail) if tail else 0)
    assert p << b["BALANCED_TOP"] < 1 << (width * L) <= p << (b["BALANCED_TOP"] + 1)
    assert b["PE3_ROW"] % 4 == 0 and 0 <= b["PE3_ROW"] - 3 * L < 4
    beta = glv_params(cfg.curve).beta
    for arr, want in (("r", cfg.r), ("r2", cfg.r2), ("beta_r2", beta * cfg.r2 % p)):
        assert sum(w << (32 * i) for i, w in enumerate(b[arr])) == want, arr
    assert cfg.r == (1 << (width * L)) % p
    if width == 13:
        t = TRAITS[name]
        assert [b[k] for k in ("W", "L", "TAIL", "N0T", "MASK", "BALANCED_TOP")] == \
            [t[k] for k in ("W", "L", "TAIL", "N0T", "MASK", "BALANCED_TOP")]
        assert all(b[k][:nw] == t[k] for k in ("r", "r2", "beta_r2"))


def test_width_blocks_are_generated():
    """csrc/widths.cuh is what scripts/torch_gen_widths.py writes from
    params.py, and its rows cover every curve at the narrow library's
    widths (ops/_build.NARROW_WIDTHS) and 13."""
    spec = importlib.util.spec_from_file_location("torch_gen_widths", ROOT / "scripts" / "torch_gen_widths.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    assert (CSRC / "widths.cuh").read_text() == gen.render()
    assert set(BLOCKS) == {(name, w) for name in CURVES for w in NARROW}
    assert set(_build.NARROW_WIDTHS) | {13} == set(NARROW) == set(_build.WIDTHS)


def test_each_other_curve_has_a_translation_unit():
    """Four translation units per curve besides BN254: csrc/curve_<name>.cu
    instantiating its point add, convert, scan and Horner ladder and the GLV
    modes of the convert and the scan, csrc/curve_<name>_prefix.cu its row
    offsets, csrc/curve_<name>_total.cu its point total,
    csrc/curve_<name>_pairs.cu its pair kernels (9-13), BPR phase 1
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
            assert f"MSM_INSTANTIATE_ROW_OFFSETS(msm::{struct})" in (CSRC / f"curve_{name}_prefix.cu").read_text()
            assert f"MSM_INSTANTIATE_POINT_TOTAL(msm::{struct})" in (CSRC / f"curve_{name}_total.cu").read_text()
            pairs = (CSRC / f"curve_{name}_pairs.cu").read_text()
            assert f"MSM_INSTANTIATE_PAIRS(msm::{struct})" in pairs
            assert f"MSM_INSTANTIATE_OFFPATH(msm::{struct})" in pairs
