#!/usr/bin/env python3
"""Instruction mix of msm_tpu_torch's CUDA kernels: builds the library as
``msm_tpu_torch.ops._build`` does (or reuses the build of these sources),
disassembles each object with ``cuobjdump -sass`` and prints, per kernel,
its static instruction count and its most frequent opcodes.

    python3 scripts/torch_sass_mix.py [name ...]

With names, only the kernels whose mangled name contains one of them (for
example ``k_scan k_horner``). Needs the CUDA toolkit (nvcc, cuobjdump) but
no GPU.
"""

from __future__ import annotations

import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from msm_tpu_torch.ops import _build  # noqa: E402

#: one SASS instruction: its address comment, then the instruction up to ';'
INSTRUCTION = re.compile(r"\s*/\*[0-9a-f]+\*/\s+([^;]+);")
PREDICATE = re.compile(r"@!?U?P\w+\s+")


def sass(obj: Path) -> dict[str, list[str]]:
    """{mangled kernel name: its instructions in order} of one object file
    (a kernel's section holds the out-of-line functions it calls)."""
    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(obj)], check=True,
                          capture_output=True, text=True).stdout
    code: dict[str, list[str]] = {}
    body = None
    for line in text.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            body = code.setdefault(m.group(1), [])
        elif body is not None and (m := INSTRUCTION.match(line)):
            body.append(" ".join(m.group(1).split()))
    return code


def opcode(instruction: str) -> str:
    return PREDICATE.sub("", instruction, count=1).split()[0]


def main(names: list[str]) -> int:
    lib = _build.build()
    for obj in sorted(lib.parent.glob("*.o")):
        for fn, body in sass(obj).items():
            if names and not any(n in fn for n in names):
                continue
            ops = Counter(map(opcode, body))
            top = ", ".join(f"{op}={k}" for op, k in ops.most_common(16))
            print(f"{obj.name} {fn}: {len(body)} instructions; {top}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
