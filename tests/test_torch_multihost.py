"""Torch twins of tests/test_multihost.py and tests/test_multiprocess.py: the
port's multi-process control plane (mjpeg423_tpu_torch/parallel/multihost.py:
initialize, local_partition, aggregate_counts on torch.distributed's gloo
backend) and its GOP partitions, against the JAX package's.

The two-process cases start 2 real worker processes that join one gloo
group on localhost, each decoding only its GOP partition (with the
single-device pipeline, or over a 2-shard mesh with the mesh pipeline);
the merged frames must be byte-equal to the NumPy oracle and the
aggregated count must be the stream's frame count.  Each run takes its port
from a socket bound to port 0, so concurrent test files never collide.
The ``cuda`` case runs the workers on cuda:0 and skips without a card:

    python -m pytest --noconftest -m cuda tests/test_torch_multihost.py
"""
import dataclasses
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

from mjpeg423_tpu.codec import decoder, encoder
from mjpeg423_tpu_torch.parallel import multihost
from torch_twins import cuda, make_test_frames  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_multihost():
    """mjpeg423_tpu.parallel.multihost (its package imports jax)."""
    pytest.importorskip("jax")
    from mjpeg423_tpu.parallel import multihost as jm

    return jm


@pytest.mark.parametrize("starts,nf,hosts", [
    ([0, 10, 20, 30], 40, 2),        # even GOPs
    ([0, 30, 31, 32, 33], 34, 2),    # one fat GOP
    ([0, 5], 10, 4),                 # more hosts than GOPs
    ([0, 7, 14], 20, 1),             # one host takes all
])
def test_partitions_match_jax(jax_multihost, starts, nf, hosts):
    got = multihost.partition_gops(starts, nf, hosts)
    want = jax_multihost.partition_gops(starts, nf, hosts)
    assert [dataclasses.astuple(p) for p in got] == \
        [dataclasses.astuple(p) for p in want]
    assert got[0].frame_lo == 0 and got[-1].frame_hi == nf
    for a, b in zip(got, got[1:]):
        assert a.gop_hi == b.gop_lo and a.frame_hi == b.frame_lo


def test_initialize_noop_and_aggregate_identity(jax_multihost):
    assert multihost.initialize() == jax_multihost.initialize() == (0, 1)
    assert multihost.aggregate_counts(42.0) == 42.0
    assert multihost.local_partition([0, 7, 14], 20) == \
        multihost.partition_gops([0, 7, 14], 20, 1)[0]


_WORKER = r"""
import os, sys

sys.modules["jax"] = None  # the port never needs it
sys.path.insert(0, os.environ["REPO_ROOT"])
import numpy as np
import torch

from mjpeg423_tpu_torch.core import format as fmt
from mjpeg423_tpu_torch.parallel import make_mesh, multihost
from mjpeg423_tpu_torch.runtime import DecodeConfig, DecodePipeline

pid, nprocs = multihost.initialize(
    coordinator_address=os.environ["COORD"],
    num_processes=int(os.environ["NPROCS"]),
    process_id=int(os.environ["PID"]),
)
assert nprocs == int(os.environ["NPROCS"]), nprocs

data = open(os.environ["STREAM"], "rb").read()
index = fmt.index_frames(data)
part = multihost.local_partition(index.gop_starts(), index.num_frames)

dev = os.environ["DEVICE"]
if os.environ["MESH"] == "1":
    # Host x device composition: this process's GOP partition decodes over
    # a 2-shard mesh of its local devices with the mesh pipeline.
    pipe = DecodePipeline(DecodeConfig(frames_per_batch=2),
                          mesh=make_mesh(2, 1, devices=[dev] * 2))
else:
    pipe = DecodePipeline(DecodeConfig(frames_per_batch=4), device=dev)
frames = {}
if part.num_frames:
    for win in pipe.decode(data, start_frame=part.frame_lo,
                           end_frame=part.frame_hi):
        for j in range(win.count):
            frames[win.start_frame + j] = win.frames[j]
assert len(frames) == part.num_frames, (len(frames), part)

total = multihost.aggregate_counts(float(len(frames)))
torch.distributed.destroy_process_group()
out = os.environ["OUT"] + f".{pid}"
np.savez(out, idx=np.array(sorted(frames)),
         frames=np.stack([frames[i] for i in sorted(frames)])
         if frames else np.zeros((0, 1, 1), np.uint32),
         total=total)
print("OK", pid, len(frames), total)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_two_processes(tmp_path, data: bytes, *, mesh: bool,
                      device: str = "cpu") -> tuple[dict, float]:
    """Two workers over one gloo group: (frame index -> frame, total)."""
    stream = tmp_path / "s.mpg"
    stream.write_bytes(data)
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    out = tmp_path / "result"
    coord = f"localhost:{_free_port()}"
    procs = []
    for pid in range(2):
        env = dict(os.environ, REPO_ROOT=str(ROOT), COORD=coord, NPROCS="2",
                   PID=str(pid), STREAM=str(stream), OUT=str(out),
                   DEVICE=device, MESH="1" if mesh else "0")
        procs.append(subprocess.Popen(
            [sys.executable, str(worker)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=240)
            assert p.returncode == 0, stderr[-2000:]
            assert "OK" in stdout
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    got, totals = {}, []
    for pid in range(2):
        z = np.load(f"{out}.{pid}.npz")
        totals.append(float(z["total"]))
        for i, fi in enumerate(z["idx"]):
            got[int(fi)] = z["frames"][i]
    assert totals[0] == totals[1]
    return got, totals[0]


@pytest.mark.parametrize("mesh", [False, True],
                         ids=["gop-partition", "mesh-pipeline"])
def test_two_process_decode(tmp_path, mesh):
    """test_multiprocess.py's two cases: each process decodes its GOP
    partition (test_two_process_gop_partition_decode) or decodes it over a
    2-shard local mesh (test_two_process_mesh_pipeline_decode); the
    partition covers the stream and every frame is exact."""
    n = 16 if mesh else 12
    frames = make_test_frames(np.random.default_rng(62 if mesh else 61),
                              num_frames=n, h=16 if mesh else 24, w=32)
    data = encoder.encode_frames(frames, max_i_interval=4)
    want = decoder.decode_stream_array(data)
    got, total = run_two_processes(tmp_path, data, mesh=mesh)
    assert total == float(n)  # the all_reduce saw every frame
    assert sorted(got) == list(range(n))
    for fi in range(n):
        np.testing.assert_array_equal(got[fi], want[fi])


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", [False, True],
                         ids=["gop-partition", "mesh-pipeline"])
def test_two_process_decode_on_card(cuda, tmp_path, mesh):
    """The same two gloo processes, both decoding on cuda:0."""
    frames = make_test_frames(np.random.default_rng(63), num_frames=16,
                              h=32, w=48)
    data = encoder.encode_frames(frames, max_i_interval=4)
    want = decoder.decode_stream_array(data)
    got, total = run_two_processes(tmp_path, data, mesh=mesh,
                                   device="cuda:0")
    assert total == 16.0 and sorted(got) == list(range(16))
    for fi in range(16):
        np.testing.assert_array_equal(got[fi], want[fi])
