"""The thumbnail cell, hd1080-thumbs, at a tiny size against its reference
(h100bench/thumbs_ref.py): the sound run is correct, each fault the cell
can have is not, and neither is the control, which at 128x96 departs too
rarely to show in a thumbnail and so runs at the cell's size on the card
(test_control_on_the_card) while test_control_departs_after_the_downscale
holds its arithmetic here.  The reference's downscale is held to the
port's NumPy oracle (imported by the test only)."""
from __future__ import annotations

import json
import types

import numpy as np
import pytest
import torch

from h100bench import mjpeg, run, thumbs_ref
from conftest import REPO, full_bench, make_tiny

CELL = "hd1080-thumbs"
SEED = 2**33 + 29


@pytest.fixture
def thumbs(tmp_path):
    """The tiny benchmark with three archives of 9, 13 and 17 frames, an
    I-frame every 4 (3, 4 and 5 thumbnails), and batches of 6 archives:
    18 thumbnails a request in windows of 4, most of them seams."""
    bench = make_tiny(tmp_path)
    path = tmp_path / "h100bench/configs/hd1080-keyframes.json"
    cfg = json.loads(path.read_text())
    cfg.update(archive_frames=[9, 17], distinct_clips=3, max_i_interval=4)
    path.write_text(json.dumps(cfg))
    path = tmp_path / "h100bench/traffic/thumbs.json"
    mix = json.loads(path.read_text())
    mix["batch_archives"] = 6
    path.write_text(json.dumps(mix))
    return tmp_path, bench


def _run(thumbs, device="cpu", trace=False, control=False):
    root, bench = thumbs
    return run.run_cell(bench, CELL, seed=SEED, seconds=0.6, trace=trace, device=device,
                        t0=0.0, control=control, repo=root)


def test_cell_is_correct(thumbs):
    r = _run(thumbs)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"decode_fps", "setup_s"}
    assert r["checks"]["frames_checked"]["value"] >= 18


def test_traced_cell_reports_its_per_layer_metrics(thumbs):
    r = _run(thumbs, trace=True)
    assert r["correct"], r["checks"]
    _, bench = thumbs
    want = {m["name"] for m in bench["per_layer"] if CELL in m["workloads"]}
    # a CPU run has no kernel time: the roofline and the downscale's
    # device time return nothing there
    assert set(r["metrics"]) == want - {"decode_kernel_roofline", "downscale_ms_per_frame"}
    assert r["metrics"]["seam_join_ms_per_frame"]["value"] > 0
    assert r["device"]["window_s"] > 0 and "breakdown" in r


def _words(seed, shape):
    """Seeded packed words, with every byte lane at 0 and at 255 among them."""
    x = np.random.default_rng(seed).integers(0, 2**32, shape, dtype=np.uint32)
    flat = x.reshape(-1)
    flat[:64] = 0
    flat[64:128] = 0xFFFFFFFF
    return x


@pytest.mark.parametrize("f", [2, 4, 8])
def test_reference_downscale_is_the_ports_oracle(f):
    from mjpeg423_tpu_torch.ops.scale import downscale_raster_host

    x = _words(f, (3, 16, 24))
    got = thumbs_ref.downscale(torch.from_numpy(x.astype(np.int64)), f)
    assert got.shape == (3, 16 // f, 24 // f)
    np.testing.assert_array_equal(got.numpy(), downscale_raster_host(x, f).astype(np.int64))


def test_control_departs_after_the_downscale():
    """The control's IDCT in float32 rounds some pixels the other way; over
    a 2048x2048 frame of seeded states, some of them move a thumbnail."""
    g = torch.Generator().manual_seed(3)
    bh = bw = 256
    state = torch.randint(-2048, 2049, (3, bh * bw, 64), generator=g).to(torch.int16)

    def thumbnail(dtype):
        y, cb, cr = (mjpeg.idct(state[p], dtype) for p in range(3))
        return thumbs_ref.downscale(
            mjpeg.blocks_to_raster(mjpeg.ycbcr_to_bgra(y, cb, cr, dtype), bh, bw), 4)

    assert (thumbnail(torch.float32) != thumbnail(torch.int32)).any()


def _ctx(probes: dict, frames=100, trace=None):
    window = types.SimpleNamespace(
        probes={n: {"total": t, "count": 1} for n, t in probes.items()},
        counts={"frames": frames}, traced={"frames": frames})
    return types.SimpleNamespace(window=window, trace=trace or {}, device_kind="cpu")


def test_seam_join_reader():
    """ms a thumbnail; 0 where no window crossed a seam; nothing from a
    program that batched archives without the probe and its counters."""
    read = run.load_reader("seam_join_ms_per_frame")
    assert read(_ctx({"parse/seam_join": 0.5, "streams/windows": 6.0})) == pytest.approx(5.0)
    assert read(_ctx({"streams/windows": 6.0, "parse/window": 1.0})) == 0
    assert read(_ctx({"parse/window": 1.0, "pipeline/parse_wait": 1.0})) is None


def test_downscale_reader_leaves_out_the_decode_kernel():
    read = run.load_reader("downscale_ms_per_frame")
    ops = [["void (anonymous namespace)::decode_window_kernel<BlockMajor>(...)", 0.004],
           ["Memcpy HtoD (Pinned -> Device)", 0.5],
           ["void at::native::reduce_kernel<...>", 0.003]]
    trace = {"kernel_s": 0.01, "device_ops": ops}
    assert read(_ctx({}, frames=20, trace=trace)) == pytest.approx(1e3 * 0.006 / 20)
    assert read(_ctx({}, trace={"kernel_s": 0.0, "device_ops": []})) is None
    assert read(_ctx({})) is None


def _first_p_frame(data: bytes) -> int:
    return mjpeg.index(data).types.index(1)


def _fault(monkeypatch, fault):
    """decode_streams with the request's first thumbnail altered: one
    channel off by one, dropped, or the thumbnail of its archive's first
    P-frame in its place."""
    from mjpeg423_tpu_torch.runtime.pipeline import DecodePipeline

    orig = DecodePipeline.decode_streams

    def decode_streams(self, datas, stop=None, iframes_only=False, scale=1):
        for n, (si, fi, thumb) in enumerate(orig(self, datas, stop, iframes_only, scale)):
            if n == 0 and fault == "iframe_dropped":
                continue
            if n == 0 and fault == "channel_off_by_one":
                thumb = thumb.copy()
                thumb[0, 0] ^= 1
            if n == 0 and fault == "p_frame_for_i_frame":
                p = _first_p_frame(datas[si])
                thumb = next(t for _, f, t in orig(self, datas[si:si + 1], scale=scale)
                             if f == p)
            yield si, fi, thumb

    monkeypatch.setattr(DecodePipeline, "decode_streams", decode_streams)


@pytest.mark.parametrize("fault", ["channel_off_by_one", "iframe_dropped",
                                   "p_frame_for_i_frame"])
def test_fault_is_not_correct(thumbs, monkeypatch, fault):
    _fault(monkeypatch, fault)
    r = _run(thumbs)
    assert not r["correct"], (fault, r["checks"])
    # caught by the comparison, not by a request that raised
    assert r["failed"] == 0
    assert any(v["value"] > v["limit"] for v in r["checks"].values()), r["checks"]


@pytest.mark.cuda
def test_cell_on_the_card(thumbs, cuda_device):
    assert _run(thumbs, device=cuda_device)["correct"]


@pytest.mark.cuda
def test_control_on_the_card(cuda_device):
    """The control at the cell's own size, in a short window."""
    r = run.run_cell(full_bench(), CELL, seed=SEED, seconds=5.0, trace=False,
                     device=cuda_device, t0=0.0, control=True, repo=REPO)
    assert not r["correct"]
    assert r["checks"]["pixels_off"]["value"] > 0, r["checks"]
