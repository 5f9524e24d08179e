#!/usr/bin/env python3
"""End-to-end decode rates of two checkouts in alternating pairs on one
NVIDIA GPU, within one call on one machine:

    python3 mjpeg423_tpu_torch/scripts/e2e_pairs.py --parent DIR [--change DIR] [--pairs N] [--runs N]

Runs each tree's own scripts/e2e_rates.py (--no-encode, --runs warm decodes
a configuration, default 3) in turn N times (default 10), the parent first
in even pairs and the change first in odd ones, each in a process of its
own, and prints one JSON line: for every
decode configuration and geometry and for each tree the median, min and
max over the N pair members of that member's median frames/s, the share of
pairs the change won, and the card's name and power limit.  Host clocks
move between calls and within one, so only trees run in turn compare.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys


def rates(root: pathlib.Path, runs: int) -> dict:
    script = root / "mjpeg423_tpu_torch" / "scripts" / "e2e_rates.py"
    cmd = [sys.executable, str(script), "--root", str(root), "--runs", str(runs)]
    if "--no-encode" in script.read_text():
        cmd.append("--no-encode")
    res = subprocess.run(cmd, capture_output=True, text=True, check=True, cwd=root)
    return json.loads(res.stdout.strip().splitlines()[-1])


def main() -> int:
    here = pathlib.Path(__file__).resolve().parents[2]
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--change", default=str(here))
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    trees = {"parent": pathlib.Path(args.parent).resolve(),
             "change": pathlib.Path(args.change).resolve()}
    got: dict[str, dict[str, list[float]]] = {}
    card = None
    for pair in range(args.pairs):
        order = list(trees.items())
        for tree, root in order[::-1] if pair % 2 else order:
            out = rates(root, args.runs)
            card = out["card"]
            for key, val in out.items():
                if key.startswith("decode "):
                    got.setdefault(key, {}).setdefault(tree, []).append(val["median"])
    summary = {"card": card, "pairs": args.pairs, "runs": args.runs}
    for key, by_tree in got.items():
        summary[key] = {
            tree: {"median": statistics.median(v), "min": min(v), "max": max(v)}
            for tree, v in by_tree.items()}
        summary[key]["pairs_won_by_change"] = sum(
            c > p for p, c in zip(by_tree["parent"], by_tree["change"]))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
