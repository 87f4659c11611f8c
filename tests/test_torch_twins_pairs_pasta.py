"""compress_pairs on Pallas and Vesta (21 limbs, 8 words), without and with GLV,
against the JAX package's compress_pairs in interpret mode
(_curve_twins.check_compress_pairs)."""

import pytest

from _curve_twins import GROUPS, check_compress_pairs


@pytest.mark.parametrize("glv", [False, True], ids=["plain", "glv"])
@pytest.mark.parametrize("name", GROUPS["pasta"])
def test_compress_pairs_matches_pallas(name, glv):
    check_compress_pairs(name, glv)
