"""The port never reaches jax, nor the JAX package.

A static check walks every source file of the port and chip_smoke.py for
imports of ``mjpeg423_tpu`` or ``jax``.  tests/conftest.py imports jax into
every test process, so the dynamic checks run in a fresh interpreter where
``sys.modules["jax"] = None`` makes any import of jax (or of a module that
needs it) raise, and end by asserting that no ``mjpeg423_tpu`` module was
loaded.  The comparisons with the JAX package's decoder and encoder are in
the parity files (tests/test_torch_pipeline.py, test_torch_encoder.py).
"""
import ast
import pathlib
import subprocess
import sys
import textwrap

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

PRELUDE = """
import sys
sys.modules["jax"] = None
import numpy as np
"""

SCRIPTS = {
    "import": """
        import mjpeg423_tpu_torch
        import mjpeg423_tpu_torch.ops.transform
        import mjpeg423_tpu_torch.ops.transform_fused
        import mjpeg423_tpu_torch.ops._build
        import mjpeg423_tpu_torch.ops.encode
        import mjpeg423_tpu_torch.ops.encode_fused
        import mjpeg423_tpu_torch.ops.scale
        import mjpeg423_tpu_torch.ops.transform_coefmajor
        import mjpeg423_tpu_torch.ops.entropy_ref
        import mjpeg423_tpu_torch.ops.encode_ref
        import mjpeg423_tpu_torch.ops.transform_ref
        import mjpeg423_tpu_torch.core.format
        import mjpeg423_tpu_torch.core.tables
        import mjpeg423_tpu_torch.native.centropy
        import mjpeg423_tpu_torch.utils
        import mjpeg423_tpu_torch.codec
        import mjpeg423_tpu_torch.codec.encoder
        import mjpeg423_tpu_torch.runtime
        import mjpeg423_tpu_torch.parallel
        import mjpeg423_tpu_torch.parallel.multihost
        import mjpeg423_tpu_torch.parallel.encode
        import mjpeg423_tpu_torch.examples.roundtrip
        import mjpeg423_tpu_torch.examples.clip_farm
        import mjpeg423_tpu_torch.examples.live_pipeline
        import mjpeg423_tpu_torch.examples.sharded_decode
        import mjpeg423_tpu_torch.examples.device_consumer
        import mjpeg423_tpu_torch.cli
        import mjpeg423_tpu_torch.codec.decoder
        import mjpeg423_tpu_torch.codec.transcode
        import mjpeg423_tpu_torch.io
        import mjpeg423_tpu_torch.runtime.serve
        import mjpeg423_tpu_torch.utils.debug
        import mjpeg423_tpu_torch.entry
        import mjpeg423_tpu_torch.bench
        import mjpeg423_tpu_torch.tools.bounds
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "triton")
               and sys.modules[m] is not None]
        assert not bad, bad
        from mjpeg423_tpu_torch.ops import _build
        assert _build._LIB is None  # nothing is built at import
    """,
    "decode_array": """
        from mjpeg423_tpu_torch.codec import encode_frames
        from mjpeg423_tpu_torch.runtime import (
            DecodeConfig, DecodePipeline, Profiler)
        rng = np.random.default_rng(5)
        base = rng.integers(0, 256, (16, 24, 3))
        frames = []
        for t in range(5):
            f = base.copy()
            f[t:t + 8, 2 * t:2 * t + 8] = 255
            frames.append(f.astype(np.uint8))
        data = encode_frames(frames, max_i_interval=3)
        pipe = DecodePipeline(DecodeConfig(frames_per_batch=2), device="cpu",
                              profiler=Profiler())
        pipe.warmup(24, 16)
        got = pipe.decode_array(data)
        assert got.shape == (5, 16, 24) and got.dtype == np.uint32
        whole = DecodePipeline(DecodeConfig(frames_per_batch=20),
                               device="cpu").decode_array(data)
        assert np.array_equal(got, whole)  # the carry crosses window seams
        res, rec = pipe.decode_resilient_array(data)
        assert np.array_equal(res, got) and rec.skipped == []
    """,
    "layouts_streams_scale": """
        from mjpeg423_tpu_torch.codec import encode_frames
        from mjpeg423_tpu_torch.ops.scale import downscale_raster_host
        from mjpeg423_tpu_torch.runtime import (
            DecodeConfig, DecodePipeline, Profiler)
        rng = np.random.default_rng(7)
        base = rng.integers(0, 256, (16, 24, 3))
        frames = []
        for t in range(5):
            f = base.copy()
            f[t:t + 8, 2 * t:2 * t + 8] = 255
            frames.append(f.astype(np.uint8))
        data = encode_frames(frames, max_i_interval=3)
        want = DecodePipeline(device="cpu").decode_array(data)
        for cfg in (dict(coef_major=True), dict(pack_i8=True)):
            prof = Profiler()
            pipe = DecodePipeline(DecodeConfig(frames_per_batch=2, **cfg),
                                  device="cpu", profiler=prof)
            pipe.warmup(24, 16)
            assert np.array_equal(pipe.decode_array(data), want)
            assert (prof.probe("parse/cm_windows").count
                    + prof.probe("parse/i8_windows").count) == 3
            a, b = pipe.decode_streams_arrays([data, data], scale=2)
            assert np.array_equal(a, downscale_raster_host(want, 2))
            assert np.array_equal(b, a)
            idx, thumbs = pipe.decode_iframes_array(data, scale=4)
            assert np.array_equal(thumbs, downscale_raster_host(want, 4)[idx])
    """,
    "encode_frames_device": """
        from mjpeg423_tpu_torch.codec import (
            EncodeConfig, encode_frames, encode_frames_device)
        rng = np.random.default_rng(6)
        frames = [rng.integers(0, 256, (16, 24, 3)).astype(np.uint8)
                  for _ in range(5)]
        want = encode_frames(frames, max_i_interval=3)
        for overlap in (False, True):
            cfg = EncodeConfig(frames_per_batch=2, overlap_device=overlap,
                               fetch_i8=overlap)
            got = encode_frames_device(frames, max_i_interval=3, config=cfg,
                                       device="cpu")
            assert got == want, overlap
    """,
    "decode_stream_sharded": """
        from mjpeg423_tpu_torch.codec import encode_frames
        from mjpeg423_tpu_torch.ops import transform_coefmajor as tc
        from mjpeg423_tpu_torch.parallel import (
            decode_stream_sharded, make_mesh)
        from mjpeg423_tpu_torch.runtime import DecodePipeline
        rng = np.random.default_rng(8)
        base = rng.integers(0, 256, (16, 24, 3))
        frames = []
        for t in range(7):
            f = base.copy()
            f[t:t + 8, 2 * t:2 * t + 8] = 255
            frames.append(f.astype(np.uint8))
        data = encode_frames(frames, max_i_interval=3)
        want = DecodePipeline(device="cpu").decode_array(data)
        for shape in ((4, 1), (2, 2)):
            mesh = make_mesh(*shape, devices=["cpu"] * 4)
            for aligned in (False, True, None):
                got = decode_stream_sharded(data, mesh, gop_aligned=aligned,
                                            use_pallas=True)
                assert np.array_equal(got, want), (shape, aligned)
        assert tc.LAUNCHES_K5 == 0  # CPU tensors take the plain version
    """,
    "mesh_encode_multihost": """
        from mjpeg423_tpu_torch.codec import (
            EncodeConfig, encode_frames, encode_frames_device)
        from mjpeg423_tpu_torch.codec.decoder import decode_stream_array
        from mjpeg423_tpu_torch.parallel import (
            decode_stream_sharded, encode_transform_sharded, make_mesh,
            multihost)
        from mjpeg423_tpu_torch.parallel.encode import (
            encode_window_fused_sharded, shard_samples)
        from mjpeg423_tpu_torch.runtime import DecodeConfig, DecodePipeline
        rng = np.random.default_rng(10)
        base = rng.integers(0, 256, (16, 24, 3))
        frames = []
        for t in range(9):
            f = base.copy()
            f[t % 8:t % 8 + 8, 2 * t:2 * t + 8] = 255
            frames.append(f.astype(np.uint8))
        data = encode_frames(frames, max_i_interval=2)
        want = decode_stream_array(data)
        mesh = make_mesh(4, 1, devices=["cpu"] * 4)
        for cfg in ({}, dict(coef_major=True)):
            pipe = DecodePipeline(DecodeConfig(frames_per_batch=2, **cfg),
                                  mesh=mesh)
            pipe.warmup(24, 16)
            assert np.array_equal(pipe.decode_array(data), want), cfg
        assert np.array_equal(decode_stream_sharded(data, mesh), want)
        got = encode_frames_device(frames, max_i_interval=2, mesh=mesh,
                                   config=EncodeConfig(frames_per_batch=4))
        assert got == data
        y = rng.integers(0, 256, (8, 6, 8, 8)).astype(np.uint8)
        ci, cp = encode_transform_sharded(*shard_samples(mesh, y, y, y),
                                          mesh=mesh)
        assert ci["y"].numpy().shape == cp["cr"].numpy().shape == (8, 6, 64)
        s3 = encode_window_fused_sharded(
            rng.integers(0, 256, (3, 4, 6, 64)).astype(np.uint8), mesh=mesh,
            blocks_h=2, blocks_w=3)
        assert s3.numpy().dtype == np.int16
        assert multihost.initialize() == (0, 1)
        assert multihost.aggregate_counts(3) == 3.0
    """,
    "live_pool_cli": """
        import io, json, os, tempfile, contextlib
        from mjpeg423_tpu_torch import cli
        from mjpeg423_tpu_torch.codec import encode_frames
        from mjpeg423_tpu_torch.codec.decoder import decode_stream_array
        from mjpeg423_tpu_torch.runtime import (
            DecodeConfig, decode_live_array, live_stream_bytes)
        from mjpeg423_tpu_torch.runtime.serve import StreamPool
        rng = np.random.default_rng(9)
        base = rng.integers(0, 256, (16, 24, 3))
        frames = []
        for t in range(7):
            f = base.copy()
            f[t:t + 8, 2 * t:2 * t + 8] = 255
            frames.append(f.astype(np.uint8))
        data = encode_frames(frames, max_i_interval=3)
        want = decode_stream_array(data)
        for cfg in ({}, dict(coef_major=True), dict(pack_i8=True)):
            got = decode_live_array(io.BytesIO(live_stream_bytes(data)),
                                    config=DecodeConfig(frames_per_batch=2, **cfg),
                                    device="cpu")
            assert np.array_equal(got, want), cfg
        seen = {}
        def sink(si, win):
            for j in range(win.count):
                seen[(si, win.start_frame + j)] = win.frames[j]
        stats = StreamPool(DecodeConfig(frames_per_batch=2),
                           devices=["cpu", "cpu"]).decode_all([data] * 3, sink=sink)
        assert stats.frames == 21 and len(seen) == 21
        assert all(np.array_equal(v, want[fi]) for (si, fi), v in seen.items())
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "a.mpg")
            open(path, "wb").write(data)
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                assert cli.main(["info", path, "--verify"]) == 0
            meta = json.loads(out.getvalue())
            assert meta["num_frames"] == 7 and meta["verify"] == "OK"
    """,
}


EPILOGUE = """
bad = [m for m in sys.modules if m.split(".")[0] == "mjpeg423_tpu"]
assert not bad, bad
print('OK')
"""


def _port_sources():
    files = sorted((ROOT / "mjpeg423_tpu_torch").rglob("*.py"))
    assert len(files) > 20
    return files + [ROOT / "chip_smoke.py"]


def test_port_sources_import_neither_jax_nor_the_jax_package():
    """No import statement (absolute, relative beyond the package, or an
    importlib call with a literal name) names mjpeg423_tpu or jax."""
    banned = {"mjpeg423_tpu", "jax", "jaxlib"}
    found = []
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif (isinstance(node, ast.Call) and node.args
                  and isinstance(node.args[0], ast.Constant)
                  and isinstance(node.args[0].value, str)
                  and getattr(node.func, "attr", getattr(node.func, "id", ""))
                  in ("import_module", "__import__")):
                names = [node.args[0].value]
            for name in names:
                if name.split(".")[0] in banned:
                    found.append(f"{path.relative_to(ROOT)}:{node.lineno} {name}")
    assert not found, found


def test_pipeline_has_no_base_in_the_jax_package():
    from mjpeg423_tpu_torch.runtime import DecodePipeline

    assert [c.__module__.split(".")[0] for c in DecodePipeline.__mro__] == [
        "mjpeg423_tpu_torch", "builtins"
    ]
    src = (ROOT / "mjpeg423_tpu_torch/runtime/pipeline.py").read_text()
    assert src.count("    def decode(") == 1
    assert src.count("    def decode_streams(") == 1


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_port_runs_with_jax_blocked(name):
    code = PRELUDE + textwrap.dedent(SCRIPTS[name]) + EPILOGUE
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert res.returncode == 0 and res.stdout.strip().endswith("OK"), (
        res.stdout + res.stderr
    )
