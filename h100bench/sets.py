"""Runs of the benchmark in sets, and the spreads that set its bounds: an
aid for whoever sets or re-reads the bounds; no run of a cell uses it.

    python3 -m h100bench.sets --cells hd1080-bulk,hd1080-resident --seeds 11,12,13 \
        --sets 2 --seconds 20 [--trace 0] [--control] --out DIR

runs every cell on every seed, the seeds of a set in turn and the sets one
after the other, each run a process of its own (`python3 -m h100bench.run`),
and appends each run's result to DIR/runs.jsonl with the cell, seed, set,
exit code and wall seconds.  Then, per cell and set, it prints each
metric's median and spread: the distance between the first and third
quartiles of `statistics.quantiles(values, n=4)` as a share of the median,
and, for a cell's two sets, the wider.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time


def spread(values: list[float]) -> float | None:
    if len(values) < 2:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else None


def summarise(rows: list[dict]) -> dict:
    """{cell: {metric: {"sets": [[median, spread, n], ...], "widest": s}}}"""
    out: dict = {}
    for r in rows:
        if not r.get("result"):
            continue
        for name, m in r["result"]["metrics"].items():
            out.setdefault(r["cell"], {}).setdefault(name, {}).setdefault(
                r["set"], []).append(m["value"])
    table: dict = {}
    for cell, metrics in out.items():
        for name, sets in metrics.items():
            rows_ = [[statistics.median(v), spread(v), len(v)] for _, v in sorted(sets.items())]
            widest = max((s for _, s, _ in rows_ if s is not None), default=None)
            table.setdefault(cell, {})[name] = {"sets": rows_, "widest": widest}
    return table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    rows = []
    with open(out / "runs.jsonl", "a") as f:
        for cell in args.cells.split(","):
            for k in range(args.sets):
                for seed in args.seeds.split(","):
                    cmd = [sys.executable, "-m", "h100bench.run", "--workload", cell,
                           "--seed", seed, "--seconds", str(args.seconds),
                           "--trace", str(args.trace)] + (["--control"] if args.control else [])
                    t = time.perf_counter()
                    p = subprocess.run(cmd, capture_output=True, text=True)
                    wall = time.perf_counter() - t
                    last = p.stdout.strip().splitlines()[-1:] or [""]
                    try:
                        result = json.loads(last[0])
                    except json.JSONDecodeError:
                        result = None
                    row = {"cell": cell, "seed": int(seed), "set": k, "rc": p.returncode,
                           "wall_s": wall, "result": result,
                           "lines": [ln for ln in p.stdout.splitlines() if ln.startswith("[")],
                           "stderr_tail": p.stderr[-1500:] if (p.returncode or not result
                                                               or not result["correct"]) else ""}
                    rows.append(row)
                    f.write(json.dumps(row) + "\n")
                    f.flush()
                    brief = result and {k2: round(v["value"], 3) for k2, v in result["metrics"].items()}
                    print(cell, seed, k, p.returncode, round(wall, 1),
                          result and result["correct"], brief, flush=True)
    print(json.dumps(summarise(rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
