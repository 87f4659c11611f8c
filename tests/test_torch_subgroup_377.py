"""validate=True on BLS12-377 through run_gpu_msm on the CPU: subgroup points pass
with the oracle's result, and a point outside the subgroup raises
ValueError at its index (test_torch_subgroup.check_validate)."""

from test_torch_subgroup import check_validate


def test_validate_checks_the_subgroup():
    check_validate("bls12_377", "run_gpu_msm")
