"""The port's sharded decode (mjpeg423_tpu_torch/parallel/: mesh, temporal,
decode) against the JAX package's on its 8-device virtual CPU mesh (Pallas
kernels in interpret mode), the JAX plain scan and the port's own
single-device pipeline.

The port's meshes here repeat the CPU device (make_mesh(devices=["cpu"] *
8)), which runs the real multi-shard code: splits, the cross-shard carry
exchange, per-shard transforms, gathers.  All comparisons are byte-equal
(tolerance 0).  The tests marked ``cuda`` run the same paths on meshes that
repeat cuda:0 and skip without a card; no jax is imported at module level,
so they also run on a machine without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_parallel.py
"""
import numpy as np
import pytest
import torch

from mjpeg423_tpu_torch import parallel as P
from mjpeg423_tpu_torch.codec import encode_frames
from mjpeg423_tpu_torch.ops import transform, transform_coefmajor as tc
from mjpeg423_tpu_torch.ops import transform_fused as tf
from mjpeg423_tpu_torch.runtime import DecodePipeline

H, WD = 32, 48
BH, BW = H // 8, WD // 8
NB = BH * BW
MESHES = [(8, 1), (4, 2), (2, 2), (1, 1)]


def cpu_mesh(n_data, n_block=1):
    return P.make_mesh(n_data, n_block, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def jpar():
    """mjpeg423_tpu's parallel package on the virtual 8-device mesh."""
    return pytest.importorskip("mjpeg423_tpu.parallel")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _clip(n, h=H, w=WD, seed=9):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w, 3))
    out = []
    for t in range(n):
        f = base.copy()
        y0, x0 = (2 * t) % (h - 8), (3 * t) % (w - 8)
        f[y0:y0 + 8, x0:x0 + 8] = 255
        out.append(f.astype(np.uint8))
    return out


# ----- mesh -----------------------------------------------------------------

def test_make_mesh_rules():
    m = P.make_mesh(4, 2, devices=["cpu"] * 8)
    assert m.shape == {P.DATA_AXIS: 4, P.BLOCK_AXIS: 2}
    assert m.axis_names == ("data", "block")
    assert all(d == torch.device("cpu") for d in m.flat()) and len(m.flat()) == 8
    assert P.make_mesh(None, 2, devices=["cpu"] * 8).shape[P.DATA_AXIS] == 4
    assert P.make_mesh(2, devices=["cpu"] * 8).shape == {"data": 2, "block": 1}
    assert not m.on_cuda()


def test_make_mesh_too_few_devices_raises_like_jax(jpar):
    with pytest.raises(ValueError) as port:
        P.make_mesh(4, 4, devices=["cpu"] * 8)
    with pytest.raises(ValueError) as ref:
        jpar.make_mesh(4, 4)
    assert str(port.value) == str(ref.value)


def test_default_mesh_is_never_the_cpu():
    if torch.cuda.is_available():
        assert P.make_mesh().on_cuda()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            P.make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            P.decode_stream_sharded(b"")


@pytest.mark.parametrize("n_data,n_block", MESHES)
def test_sharded_array_round_trip(n_data, n_block):
    x = np.arange(8 * 4 * 3, dtype=np.int16).reshape(8, 4, 3)
    mesh = cpu_mesh(n_data, n_block)
    a = P.ShardedArray.put(mesh, x, 0, 1)
    assert len(a.shards) == n_data and len(a.shards[0]) == n_block
    assert tuple(a.shards[0][0].shape) == (8 // n_data, 4 // n_block, 3)
    np.testing.assert_array_equal(a.numpy(), x)
    np.testing.assert_array_equal(np.asarray(a), x)
    rep = P.ShardedArray.put(mesh, x[:, 0, 0], 0, None)
    np.testing.assert_array_equal(rep.numpy(), x[:, 0, 0])
    words = P.ShardedArray.put(
        mesh, x.astype(np.uint32).reshape(8, 4, 3), 0, 1)
    assert words.gather().dtype == torch.uint32
    np.testing.assert_array_equal(words.numpy(), x.astype(np.uint32))


def test_sharded_array_refuses_uneven_splits():
    with pytest.raises(ValueError, match="frame axis"):
        P.ShardedArray.put(cpu_mesh(4), np.zeros((6, 4), np.int16), 0, None)
    with pytest.raises(ValueError, match="block axis"):
        P.ShardedArray.put(cpu_mesh(1, 4), np.zeros((4, 6), np.int16), 0, 1)


# ----- temporal -------------------------------------------------------------

F_SCAN = 16
PLACEMENTS = {
    # I-frames in shard 0 only (of 8 shards, 2 frames each): every later
    # shard passes the carry through.
    "shard0-only": [0, 1],
    # An I-frame in every shard: the carry restarts at each one.
    "every-shard": [0] + list(range(1, F_SCAN, 2)),
    # None but the first frame.
    "first-frame-only": [0],
    # No I-frame at frame 0: the head accumulates from zero.
    "irregular-p-first": [5, 11],
}


def _scan_inputs(placement):
    rng = np.random.default_rng(11)
    deltas = rng.integers(-32768, 32768, (F_SCAN, 5, 64)).astype(np.int16)
    seg = np.zeros(F_SCAN, bool)
    seg[PLACEMENTS[placement]] = True
    return deltas, seg


@pytest.mark.parametrize("placement", list(PLACEMENTS))
@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_sharded_scan_matches_jax(jpar, n_shards, placement):
    from mjpeg423_tpu.ops import transform_jax

    deltas, seg = _scan_inputs(placement)
    want = np.asarray(transform_jax.segmented_scan(deltas, seg))
    import jax

    jmesh = jpar.make_mesh(n_shards, 1)
    ref = np.asarray(jax.jit(  # eager shard_map runs op by op: jit it
        lambda d, s: jpar.sharded_segmented_scan(d, s, jmesh))(deltas, seg))
    np.testing.assert_array_equal(ref, want)
    got = P.sharded_segmented_scan(deltas, seg, cpu_mesh(n_shards))
    assert got.shards[0][0].dtype == torch.int16
    assert len(got.shards) == n_shards
    np.testing.assert_array_equal(got.numpy(), want)
    # ... and the port's own plain scan.
    np.testing.assert_array_equal(
        transform.segmented_scan(
            torch.from_numpy(deltas), torch.from_numpy(seg)).numpy(), want)


# ----- decode_transform_sharded* --------------------------------------------

F_DEC = 8


def _amps(seed=12):
    rng = np.random.default_rng(seed)
    return [rng.integers(-60, 60, (F_DEC, NB, 64)).astype(np.int16)
            for _ in range(3)]


def _seg(n_data, gop_aligned):
    seg = np.zeros(F_DEC, bool)
    if gop_aligned:
        seg[::F_DEC // n_data] = True  # every shard starts with an I-frame
        seg[3] = True
    else:
        seg[[0, 5]] = True
    return seg


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("gop_aligned", [False, True])
@pytest.mark.parametrize("n_data,n_block", MESHES)
def test_decode_transform_sharded_matches_jax(jpar, n_data, n_block,
                                              gop_aligned, use_pallas):
    amps, seg = _amps(), _seg(n_data, gop_aligned)
    kw = dict(blocks_h=BH, blocks_w=BW, gop_aligned=gop_aligned,
              use_pallas=use_pallas)
    want = np.asarray(jpar.decode_transform_sharded(
        *amps, seg, mesh=jpar.make_mesh(n_data, n_block), interpret=True, **kw
    ))
    got = P.decode_transform_sharded(
        *amps, seg, mesh=cpu_mesh(n_data, n_block), **kw)
    assert tuple(got.shards[0][0].shape) == (
        F_DEC // n_data, H // n_block, WD)
    assert got.shards[0][0].dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), want)
    # ... and the unsharded plain transform.
    np.testing.assert_array_equal(
        got.numpy(),
        transform.decode_transform(
            *map(torch.from_numpy, amps), torch.from_numpy(seg),
            blocks_h=BH, blocks_w=BW).numpy(),
    )


def test_decode_transform_sharded_takes_sharded_inputs():
    amps, seg = _amps(), _seg(4, False)
    mesh = cpu_mesh(4, 2)
    args = P.shard_inputs(mesh, *amps, seg)
    assert tuple(args[0].shards[0][0].shape) == (2, NB // 2, 64)
    for up in (False, True):
        for ga, s in ((False, args[3]),
                      (True, P.shard_inputs(mesh, *amps, _seg(4, True))[3])):
            got = P.decode_transform_sharded(
                *args[:3], s, mesh=mesh, blocks_h=BH, blocks_w=BW,
                gop_aligned=ga, use_pallas=up)
            want = P.decode_transform_sharded(
                *amps, s.numpy(), mesh=cpu_mesh(1, 1), blocks_h=BH,
                blocks_w=BW, use_pallas=False)
            np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("kw", [
    dict(use_pallas=False, gop_aligned=True),
    dict(use_pallas=True, gop_aligned=False),
], ids=["plain", "carry-exchange"])
def test_raster_false_needs_the_fused_path(jpar, kw):
    amps, seg = _amps(), _seg(4, True)
    with pytest.raises(ValueError, match="raster=False requires the fused"):
        P.decode_transform_sharded(
            *amps, seg, mesh=cpu_mesh(4), blocks_h=BH, blocks_w=BW,
            raster=False, **kw)
    with pytest.raises(ValueError, match="raster=False requires the fused"):
        jpar.decode_transform_sharded(
            *amps, seg, mesh=jpar.make_mesh(4, 1), blocks_h=BH, blocks_w=BW,
            raster=False, interpret=True, **kw)


def test_block_axis_must_divide_blocks_h():
    amps, seg = _amps(), _seg(1, True)
    for fn, args in ((P.decode_transform_sharded, amps),
                     (P.decode_transform_sharded3, [np.stack(amps)])):
        with pytest.raises(ValueError, match="must divide by block-axis"):
            fn(*args, seg, mesh=cpu_mesh(1, 8), blocks_h=BH, blocks_w=BW)


@pytest.mark.parametrize("raster", [False, True], ids=["blocked", "raster"])
@pytest.mark.parametrize("n_data,n_block", [(4, 1), (2, 2), (4, 2)])
def test_sharded3_matches_jax(jpar, n_data, n_block, raster):
    amps3, seg = np.stack(_amps(13)), _seg(n_data, True)
    kw = dict(blocks_h=BH, blocks_w=BW, raster=raster)
    want = np.asarray(jpar.decode_transform_sharded3(
        amps3, seg, mesh=jpar.make_mesh(n_data, n_block), interpret=True,
        rows_per_step=1, **kw))
    got = P.decode_transform_sharded3(
        amps3, seg, mesh=cpu_mesh(n_data, n_block), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    # raster=False through decode_transform_sharded delegates here.
    if not raster:
        via = P.decode_transform_sharded(
            *amps3, seg, mesh=cpu_mesh(n_data, n_block), blocks_h=BH,
            blocks_w=BW, gop_aligned=True, use_pallas=True, raster=False)
        np.testing.assert_array_equal(via.numpy(), want)
        np.testing.assert_array_equal(
            tf.blocked_to_raster_host(via.numpy(), BH, BW),
            P.decode_transform_sharded3(
                amps3, seg, mesh=cpu_mesh(n_data, n_block), blocks_h=BH,
                blocks_w=BW, raster=True).numpy())


@pytest.mark.parametrize("raster", [False, True], ids=["blocked", "raster"])
@pytest.mark.parametrize("k", [1, 2])
def test_sharded_cm_matches_jax(jpar, k, raster):
    amps3, seg = np.stack(_amps(14)), _seg(4, True)
    amps_cm = tf.to_cm(amps3, BH, BW, k)
    kw = dict(blocks_h=BH, blocks_w=BW, raster=raster)
    want = np.asarray(jpar.decode_transform_sharded_cm(
        amps_cm, seg, mesh=jpar.make_mesh(4, 1), interpret=True, **kw))
    got = P.decode_transform_sharded_cm(amps_cm, seg, mesh=cpu_mesh(4), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="block axis of 1"):
        P.decode_transform_sharded_cm(amps_cm, seg, mesh=cpu_mesh(2, 2), **kw)
    with pytest.raises(ValueError, match="inconsistent"):
        P.decode_transform_sharded_cm(
            amps_cm, seg, mesh=cpu_mesh(4), blocks_h=BH + 1, blocks_w=BW)
    with pytest.raises(ValueError, match="must divide by data shards"):
        P.decode_transform_sharded_cm(
            amps_cm[:, :6], seg[:6], mesh=cpu_mesh(4), **kw)


# ----- decode_stream_sharded ------------------------------------------------

@pytest.fixture(scope="module")
def streams():
    """name -> (container, frames from the port's single-device pipeline).
    "gops3": 11 frames, I at 0/4/8: fewer GOPs than 4 or 8 shards, and
    11 % 4 != 0.  "wide": 64x48, 12 frames, I every 3: a GOP per shard."""
    out = {}
    for name, (n, h, w, gop) in {"gops3": (11, H, WD, 4),
                                 "wide": (12, 48, 64, 3)}.items():
        data = encode_frames(_clip(n, h, w), max_i_interval=gop)
        out[name] = (data, DecodePipeline(device="cpu").decode_array(data))
    return out


@pytest.mark.parametrize("use_pallas", [None, True])
@pytest.mark.parametrize("gop_aligned", [None, False, True])
@pytest.mark.parametrize("n_data,n_block", [(4, 1), (2, 2), (8, 1), (1, 2)])
@pytest.mark.parametrize("name", ["gops3", "wide"])
def test_decode_stream_sharded_matches_single_device(
        streams, name, n_data, n_block, gop_aligned, use_pallas):
    data, want = streams[name]
    got = P.decode_stream_sharded(
        data, cpu_mesh(n_data, n_block), gop_aligned=gop_aligned,
        use_pallas=use_pallas)
    assert isinstance(got, np.ndarray) and got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("gop_aligned", [None, False, True])
@pytest.mark.parametrize("n_data,n_block", [(4, 1), (2, 2)])
def test_decode_stream_sharded_matches_jax(jpar, streams, n_data, n_block,
                                           gop_aligned):
    data, _ = streams["gops3"]
    want = np.asarray(jpar.decode_stream_sharded(
        data, jpar.make_mesh(n_data, n_block), gop_aligned=gop_aligned,
        use_pallas=True, interpret=True))
    got = P.decode_stream_sharded(
        data, cpu_mesh(n_data, n_block), gop_aligned=gop_aligned,
        use_pallas=True)
    np.testing.assert_array_equal(got, want)


def test_partitions_pad_and_drop(streams):
    """More shards than GOPs: empty partitions, and the padded frames never
    reach the output."""
    from mjpeg423_tpu_torch.core.format import index_frames
    from mjpeg423_tpu_torch.parallel.multihost import partition_gops

    data, want = streams["gops3"]
    index = index_frames(data)
    parts = partition_gops(index.gop_starts(), index.num_frames, 8)
    assert sum(p.num_frames == 0 for p in parts) == 5
    got = P.decode_stream_sharded(data, cpu_mesh(8), gop_aligned=True)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ----- on the card ----------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("placement", list(PLACEMENTS))
def test_sharded_scan_on_card(cuda, placement):
    deltas, seg = _scan_inputs(placement)
    want = transform.segmented_scan(
        torch.from_numpy(deltas), torch.from_numpy(seg)).numpy()
    mesh = P.make_mesh(4, 1, devices=[cuda] * 4)
    assert mesh.on_cuda()
    got = P.sharded_segmented_scan(deltas, seg, mesh)
    assert got.shards[3][0].device == cuda
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("n_data,n_block,gop_aligned,counter", [
    (4, 1, False, "k5"), (2, 2, False, "k5"), (4, 1, True, "k1"),
    (2, 2, True, "k1"),
])
def test_decode_stream_sharded_on_card(cuda, n_data, n_block, gop_aligned,
                                       counter):
    """One launch a cell (K5 unaligned, K1 GOP-aligned with a block axis);
    the GOP-aligned 4x1 call is the mesh pipeline: one K1 launch a window
    of each non-empty partition."""
    from mjpeg423_tpu_torch.core.format import index_frames
    from mjpeg423_tpu_torch.parallel.multihost import partition_gops

    data = encode_frames(_clip(11), max_i_interval=4)
    want = DecodePipeline(device="cpu").decode_array(data)
    mesh = P.make_mesh(n_data, n_block, devices=[cuda] * (n_data * n_block))
    before = {"k5": tc.LAUNCHES_K5, "k2": tf.LAUNCHES_CM, "k1": tf.LAUNCHES}
    got = P.decode_stream_sharded(data, mesh, gop_aligned=gop_aligned)
    after = {"k5": tc.LAUNCHES_K5, "k2": tf.LAUNCHES_CM, "k1": tf.LAUNCHES}
    np.testing.assert_array_equal(got, want)
    moved = {k: after[k] - before[k] for k in after}
    launches = n_data * n_block
    if gop_aligned and n_block == 1:
        index = index_frames(data)
        w = DecodePipeline(device="cpu").config.frames_per_batch
        launches = sum(-(-p.num_frames // w) for p in partition_gops(
            index.gop_starts(), index.num_frames, n_data))
    assert moved[counter] == launches
    assert sum(moved.values()) == launches
    # use_pallas=False: the plain transform on the card, no kernel.
    plain = P.decode_stream_sharded(
        data, mesh, gop_aligned=gop_aligned, use_pallas=False)
    np.testing.assert_array_equal(plain, want)
    assert (tc.LAUNCHES_K5, tf.LAUNCHES_CM, tf.LAUNCHES) == (
        after["k5"], after["k2"], after["k1"])


@pytest.mark.cuda
@pytest.mark.parametrize("gop_aligned", [False, True])
def test_decode_stream_sharded_over_every_card(cuda, gop_aligned):
    """The default mesh: one data shard per card, each on its own device
    and stream (on a one-card machine this is a 1x1 mesh).  With four
    cards the 2x2 mesh runs too."""
    data = encode_frames(_clip(12, 48, 64), max_i_interval=3)
    want = DecodePipeline(device="cpu").decode_array(data)
    meshes = [P.make_mesh()]
    if torch.cuda.device_count() >= 4:
        meshes.append(P.make_mesh(2, 2))
    for mesh in meshes:
        assert mesh.on_cuda()
        assert len(set(mesh.flat())) == len(mesh.flat())  # distinct cards
        got = P.decode_stream_sharded(data, mesh, gop_aligned=gop_aligned)
        np.testing.assert_array_equal(got, want)
        args = P.shard_inputs(
            mesh, *_amps(), _seg(mesh.shape[P.DATA_AXIS], gop_aligned))
        assert args[0].shards[-1][-1].device == mesh.devices[-1][-1]
    assert torch.cuda.current_device() == cuda.index
