"""Debug log — the port of ``msm_tpu/utils/log.py``: prints to stderr,
gated by the ``MSM_TPU_DEBUG`` environment variable. The JAX package's
process-index prefix belongs to its multi-host runs, which the port does
not have."""

from __future__ import annotations

import os
import sys


def debug_enabled() -> bool:
    return os.environ.get("MSM_TPU_DEBUG", "0") not in ("0", "", "false")


def debug(*args) -> None:
    """Print to stderr when MSM_TPU_DEBUG is set."""
    if debug_enabled():
        print(" ".join(str(a) for a in args), file=sys.stderr)
