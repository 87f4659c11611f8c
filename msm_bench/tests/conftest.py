"""Tests of the benchmark harness: on the CPU with the program's plain
twins at tiny sizes, and (marked ``chip``) on a CUDA card."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips at run time without one")
