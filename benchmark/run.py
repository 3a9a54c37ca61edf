"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload cornell512.render --seed 7 \\
        --seconds 20 --trace 0

From the root of a checkout.  The process keeps to the last two of the
cores it may use, with one intra-op thread.  Sets up (the set-up time
counts from the start of this process), measures for ``--seconds``,
checks the answers against the reference, prints each compared number
beside its limit on standard error and, as the last line of standard
output, one JSON object with ``correct``, ``attempted``, ``failed``,
``metrics`` and ``device`` (``--trace 1``: the per-layer metrics and
``breakdown``).  Exits 2 with no result where no card is here, too few
cards, or a module the run may not load (JAX, the JAX package) was
loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    # The host side on two fixed cores and one intra-op thread: the
    # facade's pace is the host's, and moved from process to process.
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, set(cores[-2:]))
    import torch
    torch.set_num_threads(1)
    from benchmark import harness
    try:
        result, lines = harness.run(a.workload, a.seed, a.seconds,
                                    bool(a.trace), t_start=T_START)
    except harness.RunError as e:
        print(f"benchmark: {e}", file=sys.stderr, flush=True)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: modules loaded that a run may not load: {found}",
              file=sys.stderr, flush=True)
        return 2
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
