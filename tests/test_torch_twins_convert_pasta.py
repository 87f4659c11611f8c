"""The scaled convert (convert_pack_scaled) on Pallas and Vesta (21 limbs, 8 words), in its five
modes, against make_convert_pack(..., interpret=True)
(_curve_twins.check_convert_scaled)."""

import pytest

from _curve_twins import GROUPS, MODES, check_convert_scaled


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", GROUPS["pasta"])
def test_convert_pack_scaled_matches_pallas(name, mode):
    check_convert_scaled(name, mode)
