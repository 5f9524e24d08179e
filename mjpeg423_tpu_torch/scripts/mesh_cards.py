"""Phases 7a-7d of chip_smoke.py alone: the multi-device layer (the mesh
streaming pipeline, the delegated sharded decode with its [mesh-rate]
walls, the sharded encode, decode --all-devices and two gloo processes) on
phase 4's clips, over meshes that repeat cuda:0 and, on a machine with
several cards, over every card.  The checks are chip_smoke.py's own
(mesh_phases); the script exits nonzero if any fails.

    python3 mjpeg423_tpu_torch/scripts/mesh_cards.py   # from the repo root
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

sys.modules["jax"] = None  # the port never reaches jax
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mjpeg423_tpu_torch.codec import encode_frames  # noqa: E402
from mjpeg423_tpu_torch.runtime import DecodePipeline  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("mesh_cards: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    rng = np.random.default_rng(423)
    clips, gops = {}, {}
    for gname, nf, gop in cs.CLIPS:
        h, w = cs.GEOMS[gname]
        src = cs.synthetic_clip(rng, nf, h, w)
        mpg = encode_frames(src, max_i_interval=gop)
        clips[gname] = (mpg, DecodePipeline(device="cpu").decode_array(mpg),
                        nf, src)
        gops[gname] = gop
    failures: list[str] = []
    out = cs.mesh_phases(torch.device("cuda", 0), clips, gops, failures)
    print(f"[mesh-summary] {json.dumps(out)}")
    if failures:
        print(f"mesh_cards: FAILED: {failures}", file=sys.stderr)
        return 1
    print(f"[mesh-cards] all phases passed on {torch.cuda.device_count()} "
          f"x {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
