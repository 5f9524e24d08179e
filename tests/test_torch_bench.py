"""The port's bench (mjpeg423_tpu_torch/bench.py, scripts/bench_multihost.py
and the CLI's `bench`) against the JAX bench (the root bench.py), on the
CPU at the --small size with --device cpu.

Its inputs are the JAX bench's for the same seed; every stage runs in this
process and returns every key of the JAX stage's row (the keys the JAX
bench writes only on a TPU are listed by name); every rate is finite and
positive; and the bench keeps no fallback: no card and no --device cpu is
an exit without a rate, a path whose output differs is an error row and
exit 1, a stage that fails is an error row and exit 1, the headline is the
--path one and every rep counts (the CLI's `bench` and the multi-process
bench: tests/test_torch_bench_cli.py).  The ``cuda`` cases run the bench on the
card and skip without one:

    python -m pytest --noconftest -m cuda tests/test_torch_bench.py
"""
import contextlib
import importlib.util
import io
import json
import math
import pathlib

import numpy as np
import pytest
import torch

from mjpeg423_tpu_torch import bench
from mjpeg423_tpu_torch.codec.decoder import decode_stream_array
from mjpeg423_tpu_torch.ops import transform_fused as tf
from mjpeg423_tpu_torch.tools.bounds import kernel_bound
from torch_twins import cuda  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def _load(name: str, path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_bench():
    """The root bench.py (it imports the JAX package)."""
    return _load("jax_root_bench", ROOT / "bench.py")


@pytest.fixture(autouse=True)
def short_windows(monkeypatch):
    """A short overlap window and one parse attempt: the rows' keys do not
    depend on either."""
    monkeypatch.setenv("BENCH_OVERLAP_S", "1")
    monkeypatch.setenv("BENCH_PARSE_ATTEMPTS", "1")


# ---- the JAX bench's inputs ------------------------------------------------

@pytest.mark.parametrize("f,b", [(8, 2040), (20, 300), (24, 60)])
def test_make_amps_equals_the_jax_bench(jax_bench, f, b):
    a, s = bench.make_amps(np.random.default_rng(423), f, b)
    ja, js = jax_bench.make_amps(np.random.default_rng(423), f, b)
    assert np.array_equal(a, ja) and np.array_equal(s, js)


def _jax_container(amps, w, h, reps, iframes):
    """A stage's container as the JAX bench builds it."""
    from mjpeg423_tpu.core.format import Frame, serialize_file
    from mjpeg423_tpu.native import centropy

    frames = [Frame(0 if iframes[fi] else 1,
                    *[centropy.encode_plane(amps[p, fi]) for p in range(3)])
              for fi in range(amps.shape[1])]
    return serialize_file(w, h, frames * reps)


# (stage, h, w, frames, reps, I-frames from make_amps' seg or the first only)
CONTAINERS = {
    "e2e": (272, 480, 8, 1, "seg"),
    "e2e_device": (272, 480, 8, 8, "first"),
    "latency": (480, 640, 8, 6, "first"),
    "pipeline_1080p": (272, 480, 8, 2, "first"),
}


@pytest.mark.parametrize("stage", list(CONTAINERS))
def test_stage_containers_equal_the_jax_bench(jax_bench, stage):
    h, w, f, reps, kind = CONTAINERS[stage]
    b = (h // 8) * (w // 8)
    amps, seg = bench.make_amps(np.random.default_rng(423), f, b)
    ja, jseg = jax_bench.make_amps(np.random.default_rng(423), f, b)
    iframes = seg if kind == "seg" else None
    want = _jax_container(ja, w, h, reps,
                          jseg if kind == "seg" else np.arange(f) == 0)
    assert bench.gop_container(amps, w, h, reps, iframes=iframes) == want


def test_reference_frames_equal_the_numpy_decoder():
    amps, seg = bench.make_amps(np.random.default_rng(423), 30, 6 * 8)
    seg[::7] = True
    data = bench.gop_container(amps, 64, 48, iframes=seg)
    got = bench.reference_frames(data, CPU, window=4)
    assert np.array_equal(got, decode_stream_array(data))


def test_bounds_are_the_kernel_tables():
    # PERF.md's K1 and K4 rows at 1920x1088 (20 and 16 frames).
    assert round(kernel_bound("k1", 20, 32640)["bound_ms"], 4) == 0.1322
    assert round(kernel_bound("k4", 16, 32640)["bound_ms"], 4) == 0.0898
    assert kernel_bound("k3", 20, 32640)["bound_by"] == "bytes"


# ---- every stage in this process -------------------------------------------

_REPS = ["reps", "t_median_s", "t_min_s", "t_max_s"]
_LAT = [f"{row}{suffix}" for row in (
    "first_frame_ms", "first_frame_latency_ms", "first_frame_bounded_ms",
    "seek_ms", "seek_device_ms") for suffix in ("", "_p90", "_max", "_n")]
# Each stage's row keys in the JAX bench (bench.py at 52155c6).
JAX_KEYS = {
    "parse": ["calibration_pre", "frames_per_s", "frames_per_s_balanced",
              "frames_per_s_sparse", "frames_per_s_i8",
              "sparse_nonzeros_per_block", "cm_frames_per_s", "mb_per_s",
              "geometry", "iters_per_rep", "content", *_REPS,
              "calibration_post", "attempts",
              "clean_probe_mblocks_baseline", "calibration"],
    "encode": ["calibration", "calibration_pre", "calibration_post",
               "frames_per_s", "geometry", *_REPS, "content",
               "host_residual_frames_per_s", "fdct_fraction"],
    "transcode": ["frames_per_s", "geometry", "calibration_pre",
                  "calibration_post", *_REPS],
    "e2e": ["frames_per_s", "geometry", *_REPS, "note"],
    "e2e_device": ["frames_per_s", "geometry", "frames", *_REPS,
                   "frames_per_s_i8", "i8_stats"],
    "latency": ["geometry", "gop_frames", *_LAT, "g640x480",
                "h2d_payload_mb", "h2d_ms", "seek_compute_ms",
                "seek_parse_ms", "seek_step_ms", "seek_compute_direct_ms",
                "note"],
    "pipeline_1080p": ["frames_per_s", "frames_per_s_i8", "geometry",
                       "frames", "layout", "parse_fps", "parse_fps_bm",
                       "parse_fps_cm", "parse_stats", *_REPS, "note",
                       "projected_frames_per_s_inprocess",
                       "projection_inputs", "device_idle_fraction_projected",
                       "projected_frames_per_s",
                       "projected_frames_per_s_isolated_parse",
                       "projection_isolated_inputs"],
    "overlap": ["geometry", "calibration_pre", "calibration_post",
                "kernel_fps_isolated", "kernel_fps_under_load",
                "kernel_under_load_ratio", "parse_fps_isolated",
                "parse_fps_under_load", "parse_under_load_ratio",
                "interference_factor", "overlap_window_s",
                "kernel_calls_in_window", "kernel_stats", "parse_stats",
                "note"],
    "sharded": ["frames_per_s", "n_devices", "kernel"],
    "geometry_sweep": [],  # a row per geometry, checked below
    "encode_transform": ["frames_per_s", "ms_per_batch", "geometry",
                         "rows_per_step"],
    "encode_device": ["geometry", "frames", "frames_per_s", "overlap_stats",
                      "frames_per_s_sequential", "sequential_stats",
                      "overlap_speedup_vs_sequential",
                      "frames_per_s_fetch_i8", "fetch_i8_stats",
                      "frames_per_s_host", "decomposition_s", "note"],
}
# Keys the JAX bench writes only on a TPU: notes on its development link,
# and the device-resident seek's H2D and direct decomposition (the port
# writes those on the card).
TPU_ONLY = {
    "e2e": {"note"},
    "latency": {"h2d_payload_mb", "h2d_ms", "seek_compute_ms",
                "seek_parse_ms", "seek_step_ms", "seek_compute_direct_ms",
                "note"},
    "pipeline_1080p": {"note"},
    "encode_device": {"note"},
}
# Keys of a JAX row the port leaves out: the clean-hour probe rate of the
# JAX bench's TPU host (no such rate is recorded for the port's hosts, so
# "clean" is the probes' spread alone).
DROPPED = {"parse": {"clean_probe_mblocks_baseline"}}
# Keys main() adds to a row from the run's other rows (the JAX stage took
# them as arguments): pipeline_1080p's projections, checked below.
PROJECTION_KEYS = {"projected_frames_per_s_inprocess", "projection_inputs",
                   "device_idle_fraction_projected", "projected_frames_per_s",
                   "projected_frames_per_s_isolated_parse",
                   "projection_isolated_inputs"}
ADDED_BY_MAIN = {"pipeline_1080p": PROJECTION_KEYS}
# Keys every row of the port carries.
PORT_KEYS = ["device", "torch", "cuda", "cpu_count", "launches"]
GEOMETRY_ROW = ["frames_per_s", "gpix_per_s", "rows_per_step",
                "frames_per_window"]


def _rates(row, path=""):
    """(name, value) of every rate and measured time (*_ms) in a row,
    nested rows included."""
    for k, v in row.items():
        name = f"{path}.{k}"
        if isinstance(v, dict):
            yield from _rates(v, name)
        elif ("frames_per_s" in k or "_fps" in k or k.startswith("parse_fps")
              or k.endswith("_ms")):
            yield name, v


def _stage_row(stage):
    return bench.run_stage(stage, CPU, small=True)


@pytest.mark.parametrize("stage", bench.STAGES)
def test_stage_row_has_the_jax_keys_and_finite_rates(stage):
    row = _stage_row(stage)
    want = (set(JAX_KEYS[stage]) - TPU_ONLY.get(stage, set())
            - DROPPED.get(stage, set()) - ADDED_BY_MAIN.get(stage, set()))
    assert want <= set(row), sorted(want - set(row))
    assert set(PORT_KEYS) <= set(row)
    assert row["device"] == ("host" if stage in bench.HOST_STAGES else "cpu")
    # CPU tensors take the plain versions: no kernel launches.
    assert not any(row["launches"].values())
    if stage == "latency":
        assert want - {"g640x480"} <= set(row["g640x480"])
    if stage == "geometry_sweep":
        assert set(row) >= {"320x240", "960x544"}
        for g in ("320x240", "960x544"):
            assert set(GEOMETRY_ROW) <= set(row[g])
    rates = list(_rates(row))
    assert rates
    for name, v in rates:
        assert isinstance(v, float) and math.isfinite(v) and v > 0, (name, v)


def test_pipeline_projection_is_min_of_parse_and_kernel():
    row = {"parse_fps_bm": 70.0, "parse_fps_cm": 50.0}
    paths = {"fused": {"frames_per_s": 60.0}, "cm": {"error": "x"}}
    stages = {"parse": {"frames_per_s_balanced": 90.0,
                        "cm_frames_per_s": 80.0}}
    got = bench.pipeline_projection(row, paths, stages)
    assert set(got) == PROJECTION_KEYS
    # cm has no kernel rate (its path failed): only bm pairs.
    assert got["projection_inputs"]["pairings"] == {"bm": 60.0}
    assert got["projected_frames_per_s_inprocess"] == 60.0
    assert got["projection_inputs"]["bound"] == "kernel"
    assert got["projected_frames_per_s"] == 60.0
    assert got["device_idle_fraction_projected"] == 0.0
    # Without a parse stage there is no isolated projection.
    assert "projected_frames_per_s" not in bench.pipeline_projection(
        row, paths, {})


def test_main_projects_pipeline_1080p_from_the_run(tmp_path):
    rc, head, tree = _main(["--device", "cpu", "--paths", "fused,cm",
                            "--stages", "parse,pipeline_1080p"], tmp_path)
    assert rc == 0, tree["stages"]
    row, paths = tree["stages"]["pipeline_1080p"], tree["paths"]
    assert set(JAX_KEYS["pipeline_1080p"]) - TPU_ONLY["pipeline_1080p"] \
        <= set(row)
    pairs = row["projection_inputs"]["pairings"]
    assert pairs["bm"] == round(min(row["parse_fps_bm"],
                                    paths["fused"]["frames_per_s"]), 1)
    assert pairs["cm"] == round(min(row["parse_fps_cm"],
                                    paths["cm"]["frames_per_s"]), 1)
    assert row["projected_frames_per_s_inprocess"] == max(pairs.values())
    assert row["projected_frames_per_s"] > 0


def test_sharded_reports_scaling_over_several_devices():
    h, w, f = bench.geometry(True, None)
    row = bench.stage_sharded(bench.Run(CPU, True, h, w, f),
                              devices=[CPU, CPU])
    assert row["n_devices"] == row["devices"] == 2
    assert row["scaling_efficiency"] > 0 and row["frames_per_s_one_device"] > 0


def test_one_device_does_not_pretend_to_scale():
    row = _stage_row("sharded")
    assert row["devices"] == row["n_devices"] == 1
    assert "scaling_efficiency" not in row


# ---- no fallback -----------------------------------------------------------

def _main(argv, tmp_path):
    """bench.main in this process: (exit code, headline, full tree)."""
    out = tmp_path / "full.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main(argv + ["--out", str(out)])
    lines = buf.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]), json.loads(out.read_text())


def test_headline_is_the_named_path_not_the_fastest(tmp_path):
    rc, head, tree = _main(["--device", "cpu", "--no-stages", "--path", "cm",
                            "--paths", "fused,cm,xla"], tmp_path)
    assert rc == 0
    assert head["path"] == "cm" and head["value"] == \
        tree["paths"]["cm"]["frames_per_s"]
    assert head["metric"] == "decode_480x272_frames_per_s_cpu_plain"
    assert set(tree["paths"]) == {"fused", "cm", "xla"}
    for row in tree["paths"].values():
        assert row["chain"]["reps"] == 5 and row["device"] == "cpu"
    # The run's environment names the host codec's build.
    assert tree["environment"]["native_build"] == \
        bench.centropy.build_info()


def _corrupt(fn):
    def wrapped(*a, **kw):
        frames, carry = fn(*a, **kw)
        frames = frames.clone()
        frames.view(torch.int32).view(-1)[0] ^= 1
        return frames, carry
    return wrapped


def test_a_wrong_byte_is_an_error_row_and_exit_1(tmp_path, monkeypatch):
    monkeypatch.setattr(tf, "decode_window_fused",
                        _corrupt(tf.decode_window_fused))
    rc, head, tree = _main(["--device", "cpu", "--no-stages",
                            "--paths", "fused,cm"], tmp_path)
    assert rc == 1
    assert "differs" in tree["paths"]["fused"]["error"]
    assert "frames_per_s" not in tree["paths"]["fused"]
    assert tree["paths"]["cm"]["frames_per_s"] > 0  # no path stands in
    assert "error" in head and "value" not in head
    # The pipeline's step is the same function: a stage fails as well.
    with pytest.raises(bench.BenchError):
        _stage_row("e2e")


def test_a_failed_stage_is_an_error_row_and_exit_1(tmp_path, monkeypatch):
    monkeypatch.setenv("BENCH_STAGE_TIMEOUT_S", "0.001")
    rc, head, tree = _main(["--device", "cpu", "--paths", "fused",
                            "--stages", "transcode"], tmp_path)
    assert rc == 1
    assert "timed out" in tree["stages"]["transcode"]["error"]
    assert head["value"] > 0  # the headline is still printed


def test_a_stage_runs_in_a_child_process(tmp_path):
    rc, head, tree = _main(["--device", "cpu", "--paths", "fused",
                            "--stages", "transcode"], tmp_path)
    assert rc == 0, tree["stages"]
    row = tree["stages"]["transcode"]
    assert row["device"] == "host" and row["frames_per_s"] > 0
    assert "aggregate_projection" not in tree["stages"]  # no card, no card rates


def test_no_card_exits_without_a_rate(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert bench.main([]) != 0
    assert bench.main(["--stage", "parse"]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA card" in out.err


def test_every_rep_counts():
    calls = iter([0.0, 0.0, 0.0, 0.0, 0.05])

    def fn():
        import time
        time.sleep(next(calls))

    _, stats = bench._timed_reps(fn, 5)
    assert stats["reps"] == 5 and stats["t_max_s"] >= 0.05


def test_parse_reports_the_cleanest_attempt_not_the_fastest(monkeypatch):
    # Probe pairs (pre, post) of three attempts: spreads 3.0, 1.9, 2.5,
    # rates 10% apart or more (no steady host), so every attempt runs.
    probes = iter([{"probe_mblocks_per_s": r, "probe_spread": s}
                   for r, s in ((40.0, 3.0), (40.0, 3.0), (20.0, 1.9),
                                (20.0, 1.9), (30.0, 2.5), (30.0, 2.5))])
    monkeypatch.setattr(bench, "_calibration_probe", lambda: next(probes))
    monkeypatch.setenv("BENCH_PARSE_ATTEMPTS", "3")
    monkeypatch.setenv("BENCH_PARSE_RETRY_SPACING_S", "0")
    row = bench.run_stage("parse", CPU, small=True, frames=2)
    assert [a["attempt"] for a in row["attempts"]] == [0, 1, 2]
    assert row["reported_attempt"] == 1
    assert row["calibration_pre"]["probe_spread"] == 1.9


# ---- on the card -----------------------------------------------------------

@pytest.mark.cuda
def test_bench_on_the_card(cuda, tmp_path):  # noqa: F811
    rc, head, tree = _main(["--small", "--stages", "e2e,encode_transform"],
                           tmp_path)
    assert rc == 0, tree
    assert head["value"] > 0 and head["path"] == "fused"
    for name, row in tree["paths"].items():
        k = bench.PATH_KERNEL[name]
        assert all((v > 0) == (n == k) for n, v in row["launches"].items())
        assert row["power_limit"]
    kq = tree["kernel_quality"]
    assert kq["kernel_us_per_launch"] > 0
    # One byte count a kernel: the bound's (tools/bounds.py).
    assert kq["approx_bytes_per_batch"] == kernel_bound("k1", 8, 60 * 34)["bytes"]
    assert tree["stages"]["encode_transform"]["launches"]["K4"] > 0
    assert tree["stages"]["e2e"]["launches"]["K1"] > 0
