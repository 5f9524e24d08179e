#!/usr/bin/env python3
"""The port's bench on two checkouts in alternating pairs on one NVIDIA
GPU, within one call on one machine:

    python3 mjpeg423_tpu_torch/scripts/bench_pairs.py --parent DIR [--change DIR]
        [--pairs N] [--stages parse,e2e,e2e_device,pipeline_1080p,encode_device]
        --out-dir DIR [--device cpu]

Runs `python -m mjpeg423_tpu_torch.bench --paths fused --stages STAGES` in
each tree in turn N times (default 1), the parent first in even pairs and
the change first in odd ones (parent, change, change, parent for N = 2),
each run's full tree written to --out-dir as <tree>-<run>.json.  Prints
one JSON line: for every stage and each of its frames/s keys, the value of
each run of each tree in run order, the pairs the change won, each tree's
host-codec build where its bench reports one (environment.native_build),
and the card's name and power limit.  Host clocks move between calls and
within one, so only trees run in turn compare.  --device cpu rehearses the
runs on the CPU (the bench's plain versions at its --small size).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

STAGES = "parse,e2e,e2e_device,pipeline_1080p,encode_device"


def bench(root: pathlib.Path, stages: str, out: pathlib.Path,
          device: str) -> dict:
    """One bench run in `root`: its full result tree."""
    subprocess.run([sys.executable, "-m", "mjpeg423_tpu_torch.bench",
                    "--device", device, "--paths", "fused", "--stages",
                    stages, "--out", str(out)], cwd=root, check=True,
                   stdout=sys.stderr)
    return json.loads(out.read_text())


def main() -> int:
    here = pathlib.Path(__file__).resolve().parents[2]
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--change", default=str(here))
    ap.add_argument("--pairs", type=int, default=1)
    ap.add_argument("--stages", default=STAGES)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out-dir", required=True,
                    help="where each run's full result tree goes")
    args = ap.parse_args()
    out_dir = pathlib.Path(args.out_dir).resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    trees = {"parent": pathlib.Path(args.parent).resolve(),
             "change": pathlib.Path(args.change).resolve()}
    rates: dict[str, dict[str, dict[str, list]]] = {}
    builds, card, run = {}, None, 0
    for pair in range(args.pairs):
        order = list(trees.items())
        for tree, root in order[::-1] if pair % 2 else order:
            res = bench(root, args.stages, out_dir / f"{tree}-{run}.json",
                        args.device)
            run += 1
            env = res["environment"]
            card = f"{env['device']}, {env.get('power_limit')}"
            builds[tree] = env.get("native_build")
            for stage, row in res.get("stages", {}).items():
                for key, val in row.items():
                    if "frames_per_s" in key and isinstance(val, (int, float)):
                        rates.setdefault(stage, {}).setdefault(
                            key, {}).setdefault(tree, []).append(val)
    summary = {"card": card, "pairs": args.pairs, "stages": args.stages,
               "native_build": builds, "rates": rates}
    for stage, keys in rates.items():
        for key, by_tree in keys.items():
            if set(by_tree) == set(trees):
                by_tree["pairs_won_by_change"] = sum(
                    c > p for p, c in zip(by_tree["parent"],
                                          by_tree["change"]))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
