"""The port's candidate encode path (encode_frames_device(use_pallas=False),
mjpeg423_tpu_torch/codec/encoder.py) against the JAX package's
encode_frames_device(use_pallas=False) (its XLA candidate path, on one
device and sharded over the 8-device virtual CPU mesh of tests/conftest.py)
and the port's host encode_frames.

Seeded clips of 16x16 and 24x32, 1-13 frames, windows of 1, 3, 4 and more
than the clip, I-frame intervals 1, 2 and 24.  Containers are compared byte
for byte (tolerance 0).  The tests marked ``cuda`` run the candidate path
on the card and skip without one; nothing here imports jax at module level
(the JAX side arrives through a fixture), so they also run where jax is
absent:

    python -m pytest --noconftest -m cuda tests/test_torch_encode_candidates.py
"""
import threading

import numpy as np
import pytest
import torch

from mjpeg423_tpu.codec import encoder as jax_encoder
from mjpeg423_tpu.utils.config import EncodeConfig as JaxEncodeConfig
from mjpeg423_tpu_torch.codec import EncodeConfig, encode_frames
from mjpeg423_tpu_torch.codec import encoder as penc
from mjpeg423_tpu_torch.ops import encode_fused as ef, entropy_ref
from mjpeg423_tpu_torch.parallel import Mesh, make_mesh
from mjpeg423_tpu_torch.runtime import Profiler
from torch_twins import cuda, make_test_frames  # noqa: F401

# (height, width, frames, frames_per_batch, max_i_interval)
CASES = [
    (16, 16, 1, 1, 1),
    (16, 16, 5, 3, 2),
    (16, 16, 13, 1, 24),
    (24, 32, 13, 4, 24),
    (24, 32, 13, 3, 1),
    (24, 32, 7, 16, 2),
    (24, 32, 9, 4, 2),
    (16, 16, 6, 3, 24),
]
IDS = [f"{w}x{h}-n{nf}-w{fpb}-i{mi}" for h, w, nf, fpb, mi in CASES]


def clip(h, w, nf, seed=None):
    seed = h * 1000 + w * 10 + nf if seed is None else seed
    return make_test_frames(np.random.default_rng(seed), num_frames=nf,
                            h=h, w=w)


def cpu_mesh(n_data, n_block=1):
    return make_mesh(n_data, n_block, devices=["cpu"] * (n_data * n_block))


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's encoder path and mesh (need jax)."""
    pytest.importorskip("jax")
    from mjpeg423_tpu import parallel

    return jax_encoder, parallel


def candidates(frames, mi, fpb=16, **kw):
    return penc.encode_frames_device(
        frames, max_i_interval=mi, use_pallas=False, device="cpu",
        config=EncodeConfig(frames_per_batch=fpb), **kw)


@pytest.mark.parametrize("h,w,nf,fpb,mi", CASES, ids=IDS)
def test_candidates_match_jax_and_host(jax_side, h, w, nf, fpb, mi):
    frames = clip(h, w, nf)
    got = candidates(frames, mi, fpb)
    assert got == encode_frames(frames, max_i_interval=mi)
    want = jax_side[0].encode_frames_device(
        frames, max_i_interval=mi, use_pallas=False,
        config=JaxEncodeConfig(frames_per_batch=fpb))
    assert got == want


@pytest.mark.parametrize("h,w,nf,fpb,mi", CASES[1::2], ids=IDS[1::2])
def test_serial_entropy_matches_host(h, w, nf, fpb, mi):
    frames = clip(h, w, nf)
    assert candidates(frames, mi, fpb, parallel_entropy=False) == \
        encode_frames(frames, max_i_interval=mi)


@pytest.mark.parametrize("parallel", [True, False], ids=["pool", "serial"])
def test_python_oracle_entropy_matches_host(parallel):
    frames = clip(24, 32, 6)
    got = candidates(frames, 2, 4, parallel_entropy=parallel,
                     entropy_encode=entropy_ref.encode_plane)
    assert got == encode_frames(frames, max_i_interval=2)


@pytest.mark.parametrize("parallel", [True, False], ids=["pool", "serial"])
def test_parallel_entropy_picks_the_threads(parallel):
    """parallel_entropy codes on the pool's threads, else on the caller's."""
    frames = clip(16, 16, 5)
    threads = set()
    lock = threading.Lock()

    def spy(plane):
        with lock:
            threads.add(threading.get_ident())
        return entropy_ref.encode_plane(plane)

    got = candidates(frames, 2, 2, parallel_entropy=parallel,
                     entropy_encode=spy)
    assert got == encode_frames(frames, max_i_interval=2)
    caller = threading.get_ident()
    assert (caller not in threads) if parallel else (threads == {caller})


@pytest.fixture
def path_spies(monkeypatch):
    """Which structure encode_frames_device took: 'fused' or 'candidates'."""
    taken = []
    for name, tag in (("_encode_frames_device_fused", "fused"),
                      ("_encode_frames_device_candidates", "candidates")):
        real = getattr(penc, name)

        def spy(*a, _real=real, _tag=tag, **kw):
            taken.append(_tag)
            return _real(*a, **kw)

        monkeypatch.setattr(penc, name, spy)
    return taken


@pytest.mark.parametrize("native", [False, True], ids=["no-native", "native"])
def test_none_follows_the_native_packer(monkeypatch, path_spies, native):
    """use_pallas=None on the CPU is the fused path, or the candidate path
    when the native packer is missing (its select-then-pack would be
    serial Python)."""
    monkeypatch.setattr(penc.centropy, "native_available", lambda: native)
    frames = clip(16, 16, 5)
    got = penc.encode_frames_device(frames, max_i_interval=2, device="cpu")
    assert got == encode_frames(frames, max_i_interval=2)
    assert path_spies == (["fused"] if native else ["candidates"])


def test_false_takes_candidates_true_is_refused_on_cpu(path_spies):
    frames = clip(16, 16, 3)
    candidates(frames, 2)
    assert path_spies == ["candidates"]
    with pytest.raises(ValueError, match="use_pallas"):
        penc.encode_frames_device(frames, use_pallas=True, device="cpu")
    assert path_spies == ["candidates"]


@pytest.mark.parametrize("use_pallas", [False, None], ids=["false", "none"])
def test_cuda_without_a_card_raises(use_pallas):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        penc.encode_frames_device(clip(16, 16, 2), use_pallas=use_pallas)


def test_mixed_mesh_is_refused():
    with pytest.raises(ValueError, match="mixes"):
        penc.encode_frames_device(clip(16, 16, 2), use_pallas=False,
                                  mesh=Mesh([["cpu"], ["cuda:0"]]))


@pytest.mark.parametrize("mesh", ["single", "mesh"])
def test_probes_are_recorded(mesh):
    prof = Profiler()
    frames = clip(16, 16, 5)
    kw = {"mesh": cpu_mesh(2)} if mesh == "mesh" else {}
    candidates(frames, 2, 2, profiler=prof, **kw)
    report = prof.report()
    assert {"encode/convert", "encode/device_transform",
            "encode/pack"} <= set(report)
    assert report["encode/convert"]["count"] == (3 if mesh == "single" else 1)


def test_entropy_fault_surfaces_and_the_pool_stops():
    calls = {"n": 0}

    def bad(plane):
        calls["n"] += 1
        if calls["n"] > 5:
            raise RuntimeError("packer fault")
        return entropy_ref.encode_plane(plane)

    before = threading.active_count()
    with pytest.raises(RuntimeError, match="packer fault"):
        candidates(clip(16, 16, 5), 2, 2, entropy_encode=bad)
    assert threading.active_count() <= before


@pytest.mark.parametrize("nf", [7, 8])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_mesh_candidates_match_jax(jax_side, n, nf):
    """The whole clip padded to a multiple of n, the candidates of each
    shard's first frame from its left neighbour's last."""
    frames = clip(24, 32, nf)
    jenc, jpar = jax_side
    got = candidates(frames, 3, mesh=cpu_mesh(n))
    assert got == encode_frames(frames, max_i_interval=3)
    want = jenc.encode_frames_device(
        frames, max_i_interval=3, use_pallas=False,
        mesh=jpar.make_mesh(n_data=n, n_block=1))
    assert got == want


def test_mesh_with_a_block_axis_matches_host():
    frames = clip(16, 16, 5)
    assert candidates(frames, 2, mesh=cpu_mesh(2, 2), parallel_entropy=False) \
        == encode_frames(frames, max_i_interval=2)


# ----- on the card ------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("parallel", [True, False], ids=["pool", "serial"])
def test_cuda_candidates_match_host(cuda, parallel):
    frames = clip(24, 32, 13)
    ef.COUNTS.reset()
    got = penc.encode_frames_device(
        frames, max_i_interval=4, use_pallas=False, device=cuda,
        parallel_entropy=parallel, config=EncodeConfig(frames_per_batch=4))
    assert got == encode_frames(frames, max_i_interval=4)
    assert ef.COUNTS.get("LAUNCHES") == 0


@pytest.mark.cuda
def test_cuda_mesh_candidates_match_host(cuda):
    frames = clip(24, 32, 7)
    ef.COUNTS.reset()
    got = penc.encode_frames_device(
        frames, max_i_interval=3, use_pallas=False,
        mesh=make_mesh(4, 1, devices=[cuda] * 4))
    assert got == encode_frames(frames, max_i_interval=3)
    assert ef.COUNTS.get("LAUNCHES") == 0


@pytest.mark.cuda
@pytest.mark.parametrize("native", [False, True], ids=["no-native", "native"])
def test_cuda_none_is_the_kernel(cuda, monkeypatch, path_spies, native):
    """On the card use_pallas=None is K4 whether or not the native packer
    is there: the default never gives way to the plain transform."""
    monkeypatch.setattr(penc.centropy, "native_available", lambda: native)
    frames = clip(16, 16, 5)
    ef.COUNTS.reset()
    got = penc.encode_frames_device(
        frames, max_i_interval=2, device=cuda,
        config=EncodeConfig(frames_per_batch=2))
    assert got == encode_frames(frames, max_i_interval=2)
    assert path_spies == ["fused"]
    assert ef.COUNTS.get("LAUNCHES") == 3
