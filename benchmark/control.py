"""The check's controls on the card, at a cell's own size: the readings
that its limits are set from.

    python3 benchmark/control.py --workload cornell512.render \\
        --seeds 1 2 3 --seconds 5 --mode program lowp half_batch \\
        --out controls.jsonl

For each seed and mode, one run of the cell in this process (the card's
libraries built once): ``program`` the sound program, ``lowp`` the
reference in bfloat16 in the program's place, or a fault of
``faults.py`` planted in the program.  Each run's compared numbers go to
``--out``, one JSON line a run, and to standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--mode", nargs="+", default=["program", "lowp"])
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from benchmark import harness
    with open(a.out, "a") as f:
        for mode in a.mode:
            for seed in a.seeds:
                t0 = time.perf_counter()
                result, lines = harness.run(
                    a.workload, seed, a.seconds, False,
                    lowp=mode == "lowp",
                    fault=None if mode in ("program", "lowp") else mode)
                row = dict(workload=a.workload, mode=mode, seed=seed,
                           correct=result["correct"],
                           checks={k: v["value"] for k, v in
                                   result["checks"].items()},
                           wall_s=time.perf_counter() - t0, lines=lines)
                f.write(json.dumps(row) + "\n")
                f.flush()
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
