"""The benchmark of mjpeg423_tpu_torch: one run of one cell.

    python3 -m h100bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Everything is found by name: the cell in
BENCHMARK.json, its configuration in the file BENCHMARK.json names, its
traffic mix in h100bench/traffic/<mix>.json, the mix's driver in
h100bench/drivers/<driver>.py and each per-layer metric's reader in
h100bench/metrics/<metric>.py.  The run makes its inputs from the seed,
builds and warms the program (set-up, `setup_s`), measures for --seconds
and judges what the window produced against the reference
(h100bench/mjpeg.py).  The last line of standard output is the result;
the numbers compared, each beside its limit, close standard error and the
result.  --control puts the reference's float32 variant in the program's
place for the check: its `correct` has to come out false.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "mjpeg423_tpu"}


def log(tag: str, value) -> None:
    """An earlier line of the run's standard output."""
    print(f"[{tag}] {json.dumps(value)}", flush=True)


def load_reader(name: str, root: pathlib.Path = HERE):
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"h100bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(metric: dict, cell: str, reported: set[str] | None = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric.get("moves") in reported


def run_cell(bench: dict, name: str, *, seed: int, seconds: float, trace: bool,
             device: str, t0: float, control: bool = False,
             repo: pathlib.Path = HERE.parent) -> dict:
    import torch

    from . import trace as tr

    cell = next(w for w in bench["workloads"] if w["name"] == name)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((repo / entry["file"]).read_text())
    traffic = json.loads((repo / "h100bench" / "traffic" / f"{cell['traffic']}.json").read_text())
    driver = importlib.import_module(f"h100bench.drivers.{traffic['driver']}")
    cuda = torch.device(device).type == "cuda"
    run = driver.Cell(config, traffic, seed, device, log)
    t_inputs = time.perf_counter()
    run.make_inputs()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t_program = time.perf_counter()
    run.start()
    if cuda:
        torch.cuda.synchronize()
    t_window = time.perf_counter()
    setup_s = t_window - t0
    log("setup", {"import_s": t_inputs - t0, "inputs_s": t_program - t_inputs,
                  "program_s": t_window - t_program})
    prof = None
    if trace:
        prof = tr.start_profiler(traffic["trace"]["skip"], traffic["trace"]["requests"])
    win = run.window(seconds, tr.Tracer(prof, traffic["trace"]["skip"],
                                        traffic["trace"]["requests"]))
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    analysis = {}
    if prof is not None:
        prof.stop()
        out = repo / "h100bench" / "_out"
        out.mkdir(exist_ok=True)
        path = out / f"trace-{name}.json"
        prof.export_chrome_trace(str(path))
        del prof
        analysis = tr.analyse(tr.load(path))
    metrics = {}
    if trace:
        ctx = types.SimpleNamespace(window=win, trace=analysis, config=config,
                                    device_kind=torch.cuda.get_device_name() if cuda else "cpu")
        reported = {m["name"] for m in bench["end_to_end"]
                    if applies(m, name) and (m["name"] in win.end_to_end or m["name"] == "setup_s")}
        for m in bench["per_layer"]:
            if applies(m, name, reported):
                v = load_reader(m["name"], repo / "h100bench")(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(win.end_to_end, setup_s=setup_s)
        for m in bench["end_to_end"]:
            if applies(m, name) and m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    log("window", win.counts)
    run.release()
    t = time.perf_counter()
    checks = run.check(control=control)
    log("check", {"seconds": time.perf_counter() - t})
    ok = all(c["value"] <= c["limit"] if c["op"] == "<=" else c["value"] >= c["limit"]
             for c in checks.values())
    checks["failed_requests"] = {"value": win.failed, "limit": 0, "op": "<="}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": bool(ok and win.failed == 0), "attempted": win.attempted,
              "failed": win.failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = analysis.get("busy_s", 0.0)
        dev["window_s"] = analysis.get("window_s", 0.0)
        result["breakdown"] = {"device_ops": analysis.get("device_ops", []),
                               "idle_gaps": analysis.get("idle_gaps", [])}
    result["checks"] = checks
    return result


def card_line() -> None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        log("card", out.stdout.strip())
    except (OSError, subprocess.SubprocessError) as e:
        log("card", f"nvidia-smi: {e!r}")


def main(argv=None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    import torch

    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"{args.workload} needs {cell['chips']} CUDA device(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
    result = run_cell(bench, args.workload, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device=device, t0=T0, control=args.control)
    if device == "cuda":
        card_line()
    found = sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)
    if found:
        print(f"the run loaded {found}: the benchmark may load neither JAX nor "
              "the JAX package", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']} (limit {c['op']} {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
