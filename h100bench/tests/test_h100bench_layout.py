"""What is found by name, and what a run may load."""
from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import sys

from conftest import REPO

DUMMY_METRIC = '''"""dummy_clips: the clips the window decoded."""


def read(ctx):
    return float(ctx.window.counts["clips"])
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "h100bench").rglob("*")) if p.is_file()}


def _run(root, cell, trace=0):
    """A run of the harness in its own process, from root, on the CPU."""
    code = (
        "import sys; from h100bench import run; "
        f"sys.exit(run.main(['--workload', {cell!r}, '--seed', str(2**40 + 9), "
        f"'--seconds', '0.5', '--trace', '{trace}'], device='cpu'))"
    )
    env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{REPO}")
    return subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)


def test_a_configuration_mix_and_metric_are_added_as_files(tiny):
    root, bench = tiny
    before = _digests(root)
    cfg = json.loads((root / "h100bench/configs/hd1080.json").read_text())
    cfg.update(name="dummy", width=64, height=48)
    (root / "h100bench/configs/dummy.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "h100bench/traffic/bulk.json").read_text())
    mix["clip_frames"] = [5, 7]
    (root / "h100bench/traffic/dummy_mix.json").write_text(json.dumps(mix))
    (root / "h100bench/metrics/dummy_clips.py").write_text(DUMMY_METRIC)
    bench["configs"].append(dict(bench["configs"][0], name="dummy",
                                 file="h100bench/configs/dummy.json"))
    bench["workloads"].append({"name": "dummy-cell", "config": "dummy",
                               "traffic": "dummy_mix", "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("dummy-cell")
    bench["per_layer"].append({"name": "dummy_clips", "unit": "clips", "better": "higher",
                               "source": "host_clock", "layer": "the harness",
                               "moves": "decode_fps", "workloads": ["dummy-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before
    p = _run(root, "dummy-cell", trace=1)
    assert p.returncode == 0, p.stderr[-3000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["metrics"]["dummy_clips"]["value"] >= 1


def test_a_run_loads_neither_jax_nor_the_jax_package(tiny):
    root, _ = tiny
    p = _run(root, "hd1080-bulk")
    assert p.returncode == 0, p.stderr[-3000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"]
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert p.stderr.strip().splitlines()[-1].startswith("check failed_requests")


def test_the_import_check_compares_whole_top_level_names(tiny, monkeypatch):
    """mjpeg423_tpu_torch passes; a module named jax or mjpeg423_tpu fails."""
    from h100bench import run

    assert not ({"mjpeg423_tpu_torch", "mjpeg423_tpu_torchx"} & run.FORBIDDEN)
    root, _ = tiny
    code = (
        "import sys, types; sys.modules['mjpeg423_tpu.core'] = types.ModuleType('x'); "
        "from h100bench import run; "
        "sys.exit(run.main(['--workload', 'hd1080-encode', '--seed', '3', "
        "'--seconds', '0.2'], device='cpu'))"
    )
    env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{REPO}")
    p = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 3 and "mjpeg423_tpu" in p.stderr
    assert not p.stdout.strip().splitlines()[-1].startswith("{")


def test_no_card_no_result(tiny):
    """Without a card the CLI exits non-zero and prints no result."""
    root, _ = tiny
    env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{REPO}", CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "h100bench.run", "--workload", "hd1080-bulk",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and not p.stdout.strip()


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_names_what_the_harness_finds():
    """Every cell, configuration, mix and per-layer reader is there by
    name, and every cell reports setup_s, another end-to-end metric and a
    per-layer metric."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert (REPO / c["file"]).is_file() and c["file"].startswith("h100bench/")
    for w in bench["workloads"]:
        assert w["config"] in {c["name"] for c in bench["configs"]}
        assert (REPO / "h100bench/traffic" / f"{w['traffic']}.json").is_file()
        assert len(w["why"]) <= 200 and w["chips"] == 1
        e2e = {m["name"] for m in bench["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m["workloads"] and m["moves"] in e2e
                   for m in bench["per_layer"])
    for m in bench["per_layer"]:
        assert (REPO / "h100bench/metrics" / f"{m['name']}.py").is_file()
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
