"""The port never reaches jax.

tests/conftest.py imports jax into every test process, so each check runs
in a fresh interpreter where ``sys.modules["jax"] = None`` makes any import
of jax (or of a module that needs it) raise.
"""
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
        import mjpeg423_tpu_torch.codec
        import mjpeg423_tpu_torch.codec.encoder
        import mjpeg423_tpu_torch.runtime
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "triton")
               and sys.modules[m] is not None]
        assert not bad, bad
        from mjpeg423_tpu_torch.ops import _build
        assert _build._LIB is None  # nothing is built at import
    """,
    "decode_array": """
        from mjpeg423_tpu.codec.decoder import decode_stream_array
        from mjpeg423_tpu.utils.config import DecodeConfig
        from mjpeg423_tpu_torch.codec import encode_frames
        from mjpeg423_tpu_torch.runtime import DecodePipeline, Profiler
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
        assert np.array_equal(got, decode_stream_array(data))
        res, rec = pipe.decode_resilient_array(data)
        assert np.array_equal(res, got) and rec.skipped == []
    """,
    "layouts_streams_scale": """
        from mjpeg423_tpu.codec.decoder import decode_stream_array
        from mjpeg423_tpu.utils.config import DecodeConfig
        from mjpeg423_tpu_torch.codec import encode_frames
        from mjpeg423_tpu_torch.ops.scale import downscale_raster_host
        from mjpeg423_tpu_torch.runtime import DecodePipeline, Profiler
        rng = np.random.default_rng(7)
        base = rng.integers(0, 256, (16, 24, 3))
        frames = []
        for t in range(5):
            f = base.copy()
            f[t:t + 8, 2 * t:2 * t + 8] = 255
            frames.append(f.astype(np.uint8))
        data = encode_frames(frames, max_i_interval=3)
        want = decode_stream_array(data)
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
        from mjpeg423_tpu.utils.config import EncodeConfig
        from mjpeg423_tpu_torch.codec import encode_frames, encode_frames_device
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
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_port_runs_with_jax_blocked(name):
    code = PRELUDE + textwrap.dedent(SCRIPTS[name]) + "\nprint('OK')\n"
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert res.returncode == 0 and res.stdout.strip().endswith("OK"), (
        res.stdout + res.stderr
    )
