"""The port's bench through its other entry points: the CLI's `bench`
(mjpeg423_tpu_torch/cli.py) and the multi-process bench
(mjpeg423_tpu_torch/scripts/bench_multihost.py, the counterpart of
scripts/bench_multihost.py), on the CPU with --device cpu: two real worker
processes in one gloo group on localhost, and the embedded kernel-bound
repetition the one whose efficiency is the median.  The ``cuda`` case runs
the workers on the card and skips without one:

    python -m pytest --noconftest -m cuda tests/test_torch_bench_cli.py
"""
import importlib.util
import json
import pathlib

import pytest

from mjpeg423_tpu_torch import cli
from torch_twins import cuda  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def multihost_script():
    spec = importlib.util.spec_from_file_location(
        "port_bench_multihost",
        ROOT / "mjpeg423_tpu_torch/scripts/bench_multihost.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def one_parse_attempt(monkeypatch):
    monkeypatch.setenv("BENCH_PARSE_ATTEMPTS", "1")


def test_cli_bench_runs_a_stage(capsys):
    rc = cli.main(["bench", "--device", "cpu", "--small", "--stage", "parse"])
    assert rc == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["device"] == "host" and row["frames_per_s"] > 0


def test_cli_bench_takes_device_before_the_command(capsys):
    rc = cli.main(["--device", "cpu", "bench", "--stage", "transcode"])
    assert rc == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["frames_per_s"] > 0


def test_cli_other_commands_still_refuse_unknown_arguments():
    with pytest.raises(SystemExit):
        cli.main(["info", "x.mpg", "--no-such-flag"])


def test_multihost_median_rep_is_the_median(multihost_script):
    reps = [{"rep": i, "scaling_efficiency": e}
            for i, e in enumerate((0.9, 0.5, 0.7, 0.6, 0.8))]
    assert multihost_script.median_rep(reps)["rep"] == 2


def test_bench_multihost_two_gloo_processes(multihost_script, tmp_path,
                                            capsys):
    rc = multihost_script.main([
        "--device", "cpu", "--hosts", "2", "--kb-hosts", "2",
        "--kb-reps", "3", "--frames", "16", "--width", "64", "--height", "48",
        "--out", str(tmp_path / "mh.json")])
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["n_hosts"]["hosts"] == 2 and res["frames"] == 16
    assert [h["frames"] for h in res["n_hosts"]["per_host"]] == [8, 8]
    assert res["one_host"]["frames_total"] == res["n_hosts"]["frames_total"]
    kb = res["kernel_bound"]
    samples = kb["efficiency_samples"]
    assert len(samples) == 3
    assert kb["scaling_efficiency"] == sorted(samples)[1]
    # The embedded repetition is the median one: its rates give its value.
    eff = (kb["n_hosts"]["aggregate_frames_per_s"]
           / (2 * kb["one_host"]["aggregate_frames_per_s"]))
    assert abs(eff - kb["scaling_efficiency"]) < 2e-3
    assert json.loads((tmp_path / "mh.json").read_text()) == res


@pytest.mark.cuda
def test_multihost_on_the_card(cuda, multihost_script, capsys):  # noqa: F811
    assert multihost_script.main(["--hosts", "2", "--kb-hosts", "2",
                                  "--kb-reps", "1", "--frames", "16"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["device"] == "cuda" and res["n_hosts"]["frames_total"] == 16
