"""Write msm_tpu_torch/csrc/widths.cuh, the narrow library's table of limb
width constants, from msm_tpu_torch/params.py.

The narrow library (``ops/_build.py``, every ``.cu`` compiled with
``-DMSM_LIMB_BITS=0``) takes the limb width at run time: each launch makes
one row of this table, the (curve, width) block, the curve's width block in
constant memory (``csrc/dispatch.cuh`` ``WidthScope``). A row holds, for
``MsmConfig(curve=..., word_size=W)`` with NW = ceil(modulus bits / 32):

    W, MASK       the limb width and 2^W - 1
    L             limbs of an element (MsmConfig.num_words); R = 2^(W L)
    TAIL          W L - 32 NW, in [0, 32): the REDC's last step after the
                  word REDC by 2^(32 NW)
    N0T           -p^-1 mod 2^TAIL (0 where TAIL is 0)
    BALANCED_TOP  the largest s with p 2^s < R
    PE3_ROW       a pe3 row's limbs: 3 L rounded up to a multiple of 4
    r, r2, beta_r2  R, R^2 and beta R^2 mod p in 12 words (zero above NW)

Rows run over ``params.CURVES`` (the curve index of the C entries) and the
widths 8 .. 13; 13 serves only the check of the narrow library against the
default one. ``tests/test_torch_fields_consts.py`` regenerates the file and
holds every row against params.

    python3 scripts/torch_gen_widths.py    # from the repository root
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from msm_tpu_torch.ops.glv import glv_params  # noqa: E402
from msm_tpu_torch.params import CURVES, MsmConfig, coord_words  # noqa: E402

OUT = ROOT / "msm_tpu_torch" / "csrc" / "widths.cuh"
#: the widths of the table: the narrow library's 8 .. 12, and 13
WIDTHS = tuple(range(8, 14))
#: words of the r, r2, beta_r2 arrays
MAX_NW = 12

HEADER = """\
// The narrow library's limb width constants, one row per curve (the index
// of params.CURVES) and width 8 .. 13 (WIDTH_BLOCKS[curve][width - 8]).
// Generated by scripts/torch_gen_widths.py from msm_tpu_torch/params.py;
// do not edit. Fields: the script's docstring.
#pragma once

#include <stdint.h>

namespace msm {

struct WidthBlock {
  int32_t W, L, TAIL, BALANCED_TOP, PE3_ROW;
  uint32_t MASK, N0T;
  uint32_t r[%(nw)d], r2[%(nw)d], beta_r2[%(nw)d];
};

constexpr int WIDTH_MIN = %(wmin)d, WIDTH_MAX = %(wmax)d, WIDTH_CURVES = %(curves)d;

static const WidthBlock WIDTH_BLOCKS[WIDTH_CURVES][WIDTH_MAX - WIDTH_MIN + 1] = {
"""


def block(name: str, width: int) -> dict:
    """The row of a curve and width, as the script's docstring defines it."""
    cfg = MsmConfig(curve=CURVES[name], word_size=width)
    p, nw, L = cfg.curve.modulus, coord_words(cfg), cfg.num_words
    tail = width * L - 32 * nw
    assert 0 <= tail < 32, (name, width, tail)
    top = max(s for s in range(32) if p << s < 1 << (width * L))
    beta = glv_params(cfg.curve).beta
    return {
        "W": width, "L": L, "TAIL": tail, "BALANCED_TOP": top, "PE3_ROW": -(-3 * L // 4) * 4,
        "MASK": (1 << width) - 1, "N0T": (-pow(p, -1, 1 << tail)) % (1 << tail) if tail else 0,
        "r": cfg.r, "r2": cfg.r2, "beta_r2": beta * cfg.r2 % p,
    }


def _words(v: int) -> str:
    return "{" + ", ".join(f"0x{(v >> (32 * i)) & 0xFFFFFFFF:08x}u" for i in range(MAX_NW)) + "}"


def render() -> str:
    out = [HEADER % {"nw": MAX_NW, "wmin": WIDTHS[0], "wmax": WIDTHS[-1],
                     "curves": len(CURVES)}]
    for name in CURVES:
        out.append(f"    {{  // {name}\n")
        for width in WIDTHS:
            b = block(name, width)
            out.append(
                f"        {{{b['W']}, {b['L']}, {b['TAIL']}, {b['BALANCED_TOP']}, {b['PE3_ROW']}, "
                f"0x{b['MASK']:x}u, 0x{b['N0T']:x}u,\n"
                f"         {_words(b['r'])},\n         {_words(b['r2'])},\n         {_words(b['beta_r2'])}}},\n")
        out.append("    },\n")
    out.append("};\n\n}  // namespace msm\n")
    return "".join(out)


if __name__ == "__main__":
    OUT.write_text(render())
    print(f"wrote {OUT.relative_to(ROOT)}")
