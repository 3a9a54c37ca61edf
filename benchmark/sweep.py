"""Run cells over seeds, each run its own process of ``run.py``, and sum
up their spread.

    python3 benchmark/sweep.py --workload cornell512.render \\
        --seeds 11 12 13 --seconds 20 --trace 0 --out runs.jsonl

Each run's result line, exit code, wall and the end of its standard error
go to ``--out`` (one JSON line a run); the summary (per metric the
median and the spread, (q3 - q1) / median with ``statistics.quantiles``'
quartiles, over the runs after each workload's first) goes to standard
output.  ``--workload`` may be given several times; each workload's runs
are made one after another.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def spread(values: list):
    """(median, (q3 - q1) / median) of ``values`` (None below 2 values)."""
    if len(values) < 2:
        return (values[0] if values else None), None
    q1, _, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return med, (q3 - q1) / med if med else None


def one_run(workload: str, seed: int, seconds: float, tracing: int,
            timeout: float) -> dict:
    cmd = [sys.executable, os.path.join(HERE, "run.py"), "--workload",
           workload, "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(tracing)]
    t0 = time.perf_counter()
    try:
        p = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout, cwd=os.path.dirname(HERE))
        rc, out, err = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = 124, e.stdout or "", e.stderr or ""
        out = out if isinstance(out, str) else out.decode(errors="replace")
        err = err if isinstance(err, str) else err.decode(errors="replace")
    wall = time.perf_counter() - t0
    lines = [ln for ln in out.strip().splitlines() if ln.startswith("{")]
    result = json.loads(lines[-1]) if lines and rc == 0 else None
    return dict(workload=workload, seed=seed, seconds=seconds,
                trace=tracing, rc=rc, wall_s=wall, result=result,
                stderr_tail=err[-3000:])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", action="append", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0, choices=(0, 1))
    p.add_argument("--timeout", type=float, default=1200.0)
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    ok = True
    with open(a.out, "a") as f:
        for wl in a.workload:
            runs = []
            for seed in a.seeds:
                r = one_run(wl, seed, a.seconds, a.trace, a.timeout)
                f.write(json.dumps(r) + "\n")
                f.flush()
                runs.append(r)
                res = r["result"] or {}
                print(f"{wl} seed {seed} rc {r['rc']} wall {r['wall_s']:.1f}"
                      f" correct {res.get('correct')} " + json.dumps(
                          {k: v["value"] for k, v in
                           res.get("metrics", {}).items()}), flush=True)
                if r["rc"] != 0 or not res.get("correct"):
                    ok = False
                    print(r["stderr_tail"][-1500:], flush=True)
            vals = {}
            for r in runs[1:]:
                for k, v in ((r["result"] or {}).get("metrics") or {}).items():
                    vals.setdefault(k, []).append(v["value"])
            for k, v in sorted(vals.items()):
                med, sp = spread(v)
                print(f"  {wl} {k}: median {med!r} spread {sp!r} "
                      f"n {len(v)}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
