"""The GLV tensor split and decomposition of Pallas and Vesta against the
JAX package's (tests/_glv_split.py; the other curves in
test_torch_glv.py and _256.py)."""

import pytest

from _glv_split import check_decomposition, check_tensor_split

CURVES = ["pallas", "vesta"]


@pytest.mark.parametrize("name", CURVES)
def test_tensor_split_matches_jax_device_split(name):
    check_tensor_split(name)


@pytest.mark.parametrize("name", CURVES)
def test_glv_decomposition_matches_jax(name):
    check_decomposition(name)
