"""The GLV tensor split and decomposition of secp256k1 and Grumpkin against the
JAX package's (tests/_glv_split.py; the other curves in
test_torch_glv.py and _pasta.py)."""

import pytest

from _glv_split import check_decomposition, check_tensor_split

CURVES = ["secp256k1", "grumpkin"]


@pytest.mark.parametrize("name", CURVES)
def test_tensor_split_matches_jax_device_split(name):
    check_tensor_split(name)


@pytest.mark.parametrize("name", CURVES)
def test_glv_decomposition_matches_jax(name):
    check_decomposition(name)
