"""The control at a cell's own size, in the program's place:

    python3 -m msm_bench.control --workload <name> --seeds 11 12 13 [--seconds 10]

For each seed, one run of the cell's harness with the reference, each
scalar's lowest 16-bit word dropped (``reference.control_words``), as the
system under test, judged as a run judges the program. Prints one JSON line
a seed: the number compared (``wrong_calls``) and the calls it was read
over. The benchmark's own runs never run it; it needs no card.
"""

from __future__ import annotations

import argparse
import json

from msm_bench import core


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m msm_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    bench = core.load_bench()
    cell, conf, traffic = core.cell_files(bench, args.workload)
    for seed in args.seeds:
        line, _ = core.run(cell, conf, traffic, seed, args.seconds, False, [], device="cpu", system="control")
        print(json.dumps({"workload": args.workload, "seed": seed, "system": "control",
                          "wrong_calls": line["failed"], "calls": line["attempted"], "correct": line["correct"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
