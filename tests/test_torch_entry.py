"""The port's top-level entry points (mjpeg423_tpu_torch/entry.py) against the
JAX package's (__graft_entry__.py): entry()'s decode step on the same seeded
amplitudes, and dryrun_multichip's five byte-equality passes on meshes of
the CPU repeated.  Tolerance 0.  The tests marked ``cuda`` run both on the
card and skip without one; nothing here imports jax at module level, so
they also run where jax is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_entry.py
"""
import importlib
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from mjpeg423_tpu_torch import entry as pentry
from mjpeg423_tpu_torch.ops import transform_fused as tf
from torch_twins import cuda  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_entry():
    """The repository's __graft_entry__ module (needs jax)."""
    pytest.importorskip("jax")
    spec = importlib.util.spec_from_file_location(
        "_graft_entry", ROOT / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_matches_jax(jax_entry):
    """JAX's off-TPU step (decode_transform, raster frames) and the port's
    fused window step on the CPU, on the same seeded amplitudes."""
    fn, args = pentry.entry(device="cpu")
    amps, seg, carry = args
    assert amps.shape == (3, 24, 4800, 64) and amps.dtype == torch.int16
    assert seg.tolist() == [True] + [False] * 23
    assert not carry.any()
    jfn, jargs = jax_entry.entry()
    for p in range(3):
        np.testing.assert_array_equal(amps[p].numpy(), np.asarray(jargs[p]))
    frames, new_carry = fn(*args)
    assert frames.shape == (24, 480, 640) and frames.dtype == torch.uint32
    np.testing.assert_array_equal(frames.numpy(), np.asarray(jfn(*jargs)))
    assert new_carry.shape == (3, 4800, 64)


def test_entry_blocked_layout_rasters_to_the_same_frames():
    """The step's blocked output, put in raster order, is the same frames."""
    fn, args = pentry.entry(device="cpu")
    small = (args[0][:, :3], args[1][:3], args[2])
    raster, carry = fn(*small)
    blocked, carry_b = fn(*small, raster=False)
    np.testing.assert_array_equal(
        tf.blocked_to_raster_host(blocked.numpy(), 60, 80), raster.numpy())
    assert torch.equal(carry, carry_b)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_dryrun_multichip_on_cpu(n):
    launches = pentry.dryrun_multichip(n, devices=["cpu"] * n)
    # Every pass ran, and the CPU launched no kernel.
    assert launches == {p: {} for p in ("1", "2", "3", "4", "5")}


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4", "K5"])
def test_launch_counts_read_and_reset_every_wrapper(kernel):
    """ops.launch_counts() reads each wrapper's own counter under the
    kernel's name, and ops.reset_counts() sets them all to 0."""
    from mjpeg423_tpu_torch import ops
    from mjpeg423_tpu_torch.ops._counters import KERNEL_COUNTERS

    module, name = KERNEL_COUNTERS[kernel]
    counts = importlib.import_module(f"mjpeg423_tpu_torch.ops.{module}").COUNTS
    ops.reset_counts()
    counts.add(name, 3)
    try:
        assert ops.launch_counts() == {
            k: (3 if k == kernel else 0) for k in KERNEL_COUNTERS}
    finally:
        ops.reset_counts()
    assert set(ops.launch_counts().values()) == {0}


def test_dryrun_needs_n_devices():
    with pytest.raises(ValueError, match="need 4 devices"):
        pentry.dryrun_multichip(4, devices=["cpu"] * 2)


def test_dryrun_without_devices_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        pentry.dryrun_multichip(2)


def test_entry_on_cuda_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        pentry.entry()


# ----- on the card ------------------------------------------------------------

@pytest.mark.cuda
def test_entry_on_card(cuda):
    fn, args = pentry.entry()
    before = tf.COUNTS.get("LAUNCHES")
    frames, carry = fn(*args)
    torch.cuda.synchronize()
    assert tf.COUNTS.get("LAUNCHES") - before == 1
    want, want_carry = fn(*(a.cpu() for a in args))
    assert torch.equal(frames.cpu().view(torch.int32), want.view(torch.int32))
    assert torch.equal(carry.cpu(), want_carry)


@pytest.mark.cuda
def test_dryrun_on_card(cuda):
    launches = pentry.dryrun_multichip(4, devices=[cuda] * 4)
    assert launches["1"] == {}  # the plain transform
    assert launches["1 kernels"] == {"K5": 4}  # 2x2 mesh, one a cell
    assert launches["2"] == {"K1": 4}
    assert launches["3"] == {"K1": 4}  # a 2-frame GOP a shard
    assert launches["4"] == {}
    assert launches["5"] == {"K4": 4}  # 8 frames, one window of 4 shards
