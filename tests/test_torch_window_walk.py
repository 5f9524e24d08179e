"""The decode window of any length, and the index maps of the one CUDA body
it runs on (mjpeg423_tpu_torch/ops/transform_fused.py and
csrc/decode_window.cu).

On the CPU (tolerance 0 throughout):
  * a window walked in sub-windows of at most WINDOW_CAP frames, through the
    plain versions of the three wrappers and through
    decode_transform_sharded3 / decode_transform_sharded_cm on a mesh of CPU
    devices, gives the frames and the carry of one un-walked call and of the
    JAX function (Pallas in interpret mode) on inputs made from a NumPy
    seed, full-range int16 included;
  * NumPy models of the index maps the CUDA source uses, with its constants
    read from the source text: the coefficient-major loader puts every int16
    of a tile-frame where its reader looks, exactly once, for an aligned
    tile, a tile that straddles a group, and a k*bw that is odd or only
    even; the int8 layout's row swizzle makes a warp's 1-byte column reads
    conflict-free and keeps a warp's bytes where the carry's rows put them;
    the [row][column][x] workspace is conflict-free for both roles;
  * the frame-chunk plan with each layout's own resident thread blocks, and
    the launch counters under threads.
The tests marked ``cuda`` run the walk on the card and skip without one:

    python -m pytest --noconftest -m cuda tests/test_torch_window_walk.py
"""
import pathlib
import re
import threading

import numpy as np
import pytest
import torch

from mjpeg423_tpu_torch import parallel as P
from mjpeg423_tpu_torch.ops import _build, transform_fused as tf
from mjpeg423_tpu_torch.ops._counters import LaunchCounts

CSRC = pathlib.Path(tf.__file__).resolve().parent.parent / "csrc"
H, WD = 32, 48
BH, BW = H // 8, WD // 8
NB = BH * BW
W = 16
LAYOUTS = ("bm", "cm", "i8")
COUNTER = {"bm": "LAUNCHES", "cm": "LAUNCHES_CM", "i8": "LAUNCHES_I8"}


@pytest.fixture(scope="module")
def jfused():
    """mjpeg423_tpu's Pallas kernel module (needs jax)."""
    return pytest.importorskip("mjpeg423_tpu.ops.transform_fused")


@pytest.fixture(scope="module")
def jpar():
    """mjpeg423_tpu's parallel package on the virtual 8-device mesh."""
    return pytest.importorskip("mjpeg423_tpu.parallel")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def cap(monkeypatch):
    """Sets the forced cap of frames a launch (or plain call) takes."""
    def set_cap(n):
        monkeypatch.setattr(tf, "WINDOW_CAP", n)
    return set_cap


def _window(layout, seed, w, bh, bw, full, k=1, iframes=None):
    """NumPy inputs of a window in `layout`: (planes, seg, carry, keywords).
    full: amplitudes (for i8: the DC) over all of int16."""
    rng = np.random.default_rng(seed)
    nb = bh * bw
    lo, hi = (-32768, 32768) if full else (-2047, 2048)
    amps = rng.integers(lo, hi, (3, w, nb, 64), dtype=np.int16)
    carry = rng.integers(-32768, 32768, (3, nb, 64), dtype=np.int16)
    if iframes is None:
        seg = rng.random(w) < 0.2
        seg[0] = False  # a leading P-frame continues the carry
    else:
        seg = np.zeros(w, dtype=bool)
        seg[list(iframes)] = True
    kw = dict(blocks_h=bh, blocks_w=bw)
    if layout == "i8":
        ac8 = rng.integers(-128, 128, (3, w, nb, 64), dtype=np.int8)
        ac8[..., 0] |= 1  # nonzero: the DC must replace it
        return (np.ascontiguousarray(amps[..., 0]), ac8), seg, carry, kw
    kw["rows_per_step"] = k
    if layout == "cm":
        return (tf.to_cm(amps, bh, bw, k),), seg, tf.to_cm(carry, bh, bw, k), kw
    return (amps,), seg, carry, kw


def _port(layout, planes, seg, carry, device="cpu", **kw):
    fn = {"bm": tf.decode_window_fused, "cm": tf.decode_window_fused_cm,
          "i8": tf.decode_window_fused_i8}[layout]
    f, c = fn(*(torch.from_numpy(a).to(device) for a in (*planes, seg, carry)), **kw)
    return f.cpu().numpy(), c.cpu().numpy()


def _jax(jfused, layout, planes, seg, carry, **kw):
    fn = {"bm": jfused.decode_window_fused, "cm": jfused.decode_window_fused_cm,
          "i8": jfused.decode_window_fused_i8}[layout]
    f, c = fn(*planes, seg, carry, interpret=True, **kw)
    return np.asarray(f), np.asarray(c)


# ---- the walk on the CPU ------------------------------------------------------

def test_walk_window_steps_and_carry_chain():
    """Sub-windows of at most the cap, in order, each handed the carry the
    one before returned, each writing its slice of one output tensor."""
    seen = []

    def step(lo, hi, carry, out):
        seen.append((lo, hi, int(carry), tuple(out.shape)))
        out.view(torch.int32).fill_(lo)
        return carry + (hi - lo)

    frames, carry = tf._walk_window(11, 4, torch.tensor(100), (2, 3), step)
    assert seen == [(0, 4, 100, (4, 2, 3)), (4, 8, 104, (4, 2, 3)),
                    (8, 11, 108, (3, 2, 3))]
    assert int(carry) == 111
    assert frames.dtype == torch.uint32 and tuple(frames.shape) == (11, 2, 3)
    assert frames.view(torch.int32)[:, 0, 0].tolist() == [0] * 4 + [4] * 4 + [8] * 3
    with pytest.raises(ValueError, match="cap"):
        tf._walk_window(3, 0, torch.tensor(0), (1,), step)


@pytest.mark.parametrize("full", [False, True], ids=["vli", "full-int16"])
@pytest.mark.parametrize("n", [3, 7])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_walked_window_equals_one_call_and_jax(jfused, cap, layout, n, full):
    planes, seg, carry, kw = _window(layout, 60 + n + full, W, BH, BW, full)
    for raster in (True, False):
        want, want_c = _port(layout, planes, seg, carry, raster=raster, **kw)
        cap(n)
        before = tf.COUNTS.read()
        got, got_c = _port(layout, planes, seg, carry, raster=raster, **kw)
        assert tf.COUNTS.read() == before  # the CPU path launches no kernel
        cap(None)
        assert got.dtype == want.dtype == np.uint32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_c, want_c)
        ref, ref_c = _jax(jfused, layout, planes, seg, carry, raster=raster, **kw)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got_c, ref_c)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_walk_with_a_fold_and_no_iframe(cap, layout):
    """Every sub-window continues from the carry alone; fold 2 where the
    layout has one."""
    k = 1 if layout == "i8" else 2
    planes, seg, carry, kw = _window(layout, 77, 10, BH, BW, True, k=k, iframes=())
    want, want_c = _port(layout, planes, seg, carry, raster=False, **kw)
    cap(3)
    got, got_c = _port(layout, planes, seg, carry, raster=False, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_c, want_c)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_a_cap_at_or_above_the_window_is_one_plain_call(cap, layout, monkeypatch):
    planes, seg, carry, kw = _window(layout, 5, 4, BH, BW, False)
    calls = []
    real = tf._walk_window
    monkeypatch.setattr(tf, "_walk_window",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    for n in (4, 9):
        cap(n)
        _port(layout, planes, seg, carry, **kw)
    assert calls == []
    cap(3)
    _port(layout, planes, seg, carry, **kw)
    assert len(calls) == 1


def _sharded_inputs(seed, n_data):
    rng = np.random.default_rng(seed)
    amps3 = rng.integers(-32768, 32768, (3, W, NB, 64), dtype=np.int16)
    seg = np.zeros(W, dtype=bool)
    seg[::W // n_data] = True  # every shard starts with an I-frame
    seg[5] = True
    return amps3, seg


@pytest.mark.parametrize("n", [3, 7])
@pytest.mark.parametrize("n_data,n_block", [(2, 1), (2, 2)])
def test_sharded3_walks_its_shards(jpar, cap, n_data, n_block, n):
    """8 frames a shard, walked 3 or 7 at a time from the zero carry."""
    amps3, seg = _sharded_inputs(81 + n, n_data)
    kw = dict(blocks_h=BH, blocks_w=BW, raster=True)
    mesh = P.make_mesh(n_data, n_block, devices=["cpu"] * 8)
    want = P.decode_transform_sharded3(amps3, seg, mesh=mesh, **kw).numpy()
    cap(n)
    got = P.decode_transform_sharded3(amps3, seg, mesh=mesh, **kw).numpy()
    cap(None)
    np.testing.assert_array_equal(got, want)
    ref = np.asarray(jpar.decode_transform_sharded3(
        amps3, seg, mesh=jpar.make_mesh(n_data, n_block), interpret=True,
        rows_per_step=1, **kw))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n", [3, 7])
@pytest.mark.parametrize("k", [1, 2])
def test_sharded_cm_walks_its_shards(jpar, cap, k, n):
    amps3, seg = _sharded_inputs(91 + n + k, 2)
    amps_cm = tf.to_cm(amps3, BH, BW, k)
    kw = dict(blocks_h=BH, blocks_w=BW, raster=False)
    mesh = P.make_mesh(2, 1, devices=["cpu"] * 8)
    want = P.decode_transform_sharded_cm(amps_cm, seg, mesh=mesh, **kw).numpy()
    cap(n)
    got = P.decode_transform_sharded_cm(amps_cm, seg, mesh=mesh, **kw).numpy()
    cap(None)
    np.testing.assert_array_equal(got, want)
    ref = np.asarray(jpar.decode_transform_sharded_cm(
        amps_cm, seg, mesh=jpar.make_mesh(2, 1), interpret=True, **kw))
    np.testing.assert_array_equal(got, ref)


# ---- the index maps of csrc/decode_window.cu ------------------------------------

def _code() -> str:
    """The source without its // comments."""
    path = CSRC / "decode_window.cu"
    return "\n".join(line.split("//")[0] for line in path.read_text().splitlines())


def _const(name: str) -> int:
    """A constexpr int of the source, its expression evaluated over the
    constants before it."""
    known = {}
    for m in re.finditer(r"constexpr\s+int\s+(\w+)\s*=\s*([^;]+);", _code()):
        try:
            known.setdefault(m.group(1), int(eval(m.group(2), {}, dict(known))))
        except (NameError, SyntaxError):
            continue  # a member constant that names another struct's
    return known[name]


def test_the_source_holds_one_frame_loop():
    code = _code()
    assert len(re.findall(r"__global__", code)) == 1
    assert len(re.findall(r"s_seg\s*=", code)) == 1
    assert "decode_window_bm_kernel" not in code
    for gone in ("IN_STRIDE", "WS_STRIDE"):
        assert gone not in code
    for launch in ("launch<BlockMajor>(", "launch<PackedI8>(",
                   "launch<CoefMajor<decltype(align)::value>>("):
        assert launch in code, launch
    assert _const("MAX_W") == 1024 and _const("TILE") == 32
    assert _const("THREADS") == 8 * _const("TILE")
    assert _const("STAGE_PLANE") == _const("TILE") * 64 * 2


CM_TILES = {
    # name: (blocks in a plane, k*bw, first block of the tile, copy width)
    "aligned-640x480": (4800, 80, 160, 16),
    "straddles-a-group-1080p": (32640, 240, 224, 16),
    "odd-k3-bw7": (42, 21, 0, 2),
    "odd-ragged-last-tile": (42, 21, 32, 2),
    "even-bw10": (40, 10, 32, 4),
    "eight-below-a-tile": (24, 8, 0, 16),
}


@pytest.mark.parametrize("name", list(CM_TILES))
def test_cm_loader_covers_a_tile_frame_once(name):
    """The loader of the coefficient-major layout in NumPy: thread t copies,
    of coefficient row 8 (t % 32 / 4) + t / 32, the piece of 8 blocks from
    tile0 + t % 4 * 8 to int16 number 8 t of the staged plane, in copies of
    16, 4 or 2 bytes; pass 1's thread (x, l) reads coefficient 8 r + l of
    block x at int16 number 256 l + 32 r + x."""
    code = _code()
    for text in ("b0(tile0 + (t & 3) * 8)", "(((t & 31) >> 2) * 8 + (t >> 5)) * g.bwe",
                 "+ t * 16)", "cidx((t >> 5) * 256 + (t & 31))",
                 "const int grp = b / bwe;", "rd[p * (STAGE_PLANE / 2) + r * 32]"):
        assert text in code, text
    nb, bwe, tile0, width = CM_TILES[name]
    tile, threads = _const("TILE"), _const("THREADS")
    groups = nb // bwe
    plane = np.arange(groups * 64 * bwe, dtype=np.int64).reshape(groups, 64, bwe)
    flat = plane.reshape(-1)
    assert (width == 16) == (bwe % 8 == 0) and (width >= 4) == (bwe % 2 == 0)
    staged = np.full(_const("STAGE_PLANE") // 2, -1, dtype=np.int64)
    writes = np.zeros_like(staged)
    for t in range(threads):
        b0 = tile0 + (t & 3) * 8
        row = ((t & 31) >> 2) * 8 + (t >> 5)
        for e in range(0, 8, width // 2):  # one copy of `width` bytes
            b = b0 + e
            if b >= nb:
                break
            at = (b // bwe) * 64 * bwe + row * bwe + b % bwe
            assert at * 2 % width == 0  # the copy is aligned in the plane
            n = width // 2
            # ... and does not leave its group's row
            assert b % bwe + n <= bwe and b + n <= nb
            staged[t * 8 + e:t * 8 + e + n] = flat[at:at + n]
            writes[t * 8 + e:t * 8 + e + n] += 1
    valid = min(tile, nb - tile0)
    assert writes.sum() == 64 * valid and writes.max() == 1
    for l in range(8):
        for x in range(valid):
            b = tile0 + x
            for r in range(8):
                assert staged[256 * l + 32 * r + x] == plane[b // bwe, 8 * r + l, b % bwe]


def _banks(byte_addresses, width):
    """(distinct banks, distinct words) touched by a warp's accesses of
    `width` bytes: equal when no two lanes meet in a bank at different
    words (lanes in one word are served together)."""
    words = set()
    for a in byte_addresses:
        words.update(range(a // 4, (a + width + 3) // 4))
    return len({w % 32 for w in words}), len(words)


def test_i8_swizzle_keeps_column_reads_conflict_free_and_warp_private():
    code = _code()
    for text in ("sw8((blk >> 1) & 1)",
                 "+ blk * 128 + (blk & 1) * 64 + ((l ^ sw8) << 3))",
                 "in[p * STAGE_PLANE + ((r ^ sw8) << 3)]", "sw((blk & 3) << 1)",
                 "+ blk * 128 + ((l ^ sw) << 4))"):
        assert text in code, text
    threads = _const("THREADS")

    def slot(blk, swizzled=True):
        return blk * 128 + (blk & 1) * 64, ((blk >> 1) & 1) if swizzled else 0

    written = set()
    for t in range(threads):  # the loader: row l of block blk, 8 bytes
        blk, l = t >> 3, t & 7
        base, sw = slot(blk)
        row = range(base + ((l ^ sw) << 3), base + ((l ^ sw) << 3) + 8)
        assert not written & set(row)
        written |= set(row)
        # inside the warp's 512 bytes, where the carry's 16-byte rows land
        carry_row = blk * 128 + ((l ^ ((blk & 3) << 1)) << 4)
        for a in (row[0], row[-1], carry_row, carry_row + 15):
            assert a // 512 == t // 32
    for warp in range(threads // 32):
        for r in range(8):
            reads = []
            for lane in range(32):
                t = warp * 32 + lane
                base, sw = slot(t >> 3)
                reads.append(base + ((r ^ sw) << 3) + (t & 7))
            assert set(reads) <= written
            banks, words = _banks(reads, 1)
            assert banks == words == 8
    # Without the row swap, or with blocks 64 bytes apart, blocks 0 and 2
    # meet in their banks.
    for addr in (lambda blk, l: slot(blk, False)[0] + l, lambda blk, l: blk * 64 + l):
        banks, words = _banks([addr(lane >> 3, lane & 7) for lane in range(32)], 1)
        assert banks < words


def test_bm_swizzle_and_workspace_are_conflict_free():
    """K1's and K3's roles: 2-byte column reads of a warp in 16 banks, two
    lanes a word; 4-byte column stores and 16-byte row loads of the
    72-word workspace without a conflict."""
    code = _code()
    assert "return 72 * b + 4 * ((b >> 2) & 1);" in code
    for r in range(8):
        reads = [(lane >> 3) * 128 + ((r ^ (((lane >> 3) & 3) << 1)) << 4) + (lane & 7) * 2
                 for lane in range(32)]
        assert _banks(reads, 2) == (16, 16)

    def base(b):
        return 72 * b + 4 * ((b >> 2) & 1)

    for warp in range(8):
        for r in range(8):
            stores = [4 * (base(warp * 4 + (lane >> 3)) + (lane & 7) + r * 8)
                      for lane in range(32)]
            assert _banks(stores, 4) == (32, 32)
        for half in range(2):
            for quarter in range(4):  # 16-byte loads go a quarter-warp at a time
                loads = [4 * (base(lane) + warp * 8 + half * 4)
                         for lane in range(quarter * 8, quarter * 8 + 8)]
                assert _banks(loads, 16) == (32, 32)


def test_cm_workspace_is_conflict_free_for_both_roles():
    """[plane][row][column][x] words: pass 1's thread (x, l) stores row r of
    column l, pass 2's thread (x, l2) loads column c of row l2, both over
    consecutive lanes, and pass 2 finds what pass 1 stored."""
    code = _code()
    for text in ("WS_PLANE = 64 * TILE", "WS_STEP = 8 * TILE",
                 "return l2 * (8 * TILE) + x;", "w[p * WS_PLANE + c * TILE]",
                 "int ws_col() const { return tid; }"):
        assert text in code, text
    tile = _const("TILE")
    ws = np.full(64 * tile, -1)
    for t in range(_const("THREADS")):
        x, l = t & 31, t >> 5
        for r in range(8):
            ws[t + r * 8 * tile] = (r * 8 + l) * 1000 + x
    for l in range(8):
        for r in range(8):
            stores = [4 * (l * 32 + x + r * 8 * tile) for x in range(32)]
            assert _banks(stores, 4) == (32, 32)
    for l2 in range(8):
        for c in range(8):
            loads = [l2 * 8 * tile + x + c * tile for x in range(32)]
            assert _banks([4 * a for a in loads], 4) == (32, 32)
            assert [ws[a] for a in loads] == [(l2 * 8 + c) * 1000 + x for x in range(32)]


# ---- slots, chunks and counters ---------------------------------------------------

def test_window_chunk_frames_with_each_layouts_slots(monkeypatch):
    """Each instantiation is asked for its own resident thread blocks, once
    per device, and its frame chunks follow from them."""
    asked = []

    class Lib:
        @staticmethod
        def mj423_decode_window_slots(layout, device):
            asked.append((layout, device))
            return {0: 528, 1: 396, 2: 660}[layout]

    monkeypatch.setattr(_build, "load", lambda: Lib)
    monkeypatch.setattr(tf, "_SLOTS", {})
    dev = torch.device("cuda", 0)
    slots = {name: tf.window_slots(dev, name) for name in LAYOUTS}
    assert slots == {"bm": 528, "cm": 396, "i8": 660}
    assert tf.window_slots(dev) == 528 and tf.window_slots(dev, "i8") == 660
    assert asked == [(0, 0), (1, 0), (2, 0)]  # cached per device and layout
    # 640x480: 150 tiles.  528 slots: 3 chunks of 7; 396: 2 of 10; 660: 4 of 5.
    assert [tf.window_chunk_frames(20, 150, s) for s in slots.values()] == [7, 10, 5]
    # 1920x1088: 1,020 tiles fill any of them: one chunk.
    assert {tf.window_chunk_frames(20, 1020, s) for s in slots.values()} == {20}
    with pytest.raises(KeyError):
        tf.window_slots(dev, "raster")


def test_launch_counts_from_four_threads():
    counts = LaunchCounts("A", "B")

    def work():
        for _ in range(5000):
            counts.add("A")
            counts.add("B", 2)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert counts.read() == {"A": 20000, "B": 40000} and counts.get("B") == 40000
    counts.reset()
    assert counts.read() == {"A": 0, "B": 0}
    with pytest.raises(KeyError):
        counts.add("C")


def test_counters_are_module_attributes_of_every_wrapper():
    from mjpeg423_tpu_torch.ops import encode_fused as ef, transform_coefmajor as tc

    assert set(tf.COUNTS.read()) == {"LAUNCHES", "LAUNCHES_CM", "LAUNCHES_I8"}
    for mod, names in ((tf, tf.COUNTS.read()), (ef, ["LAUNCHES"]), (tc, ["LAUNCHES_K5"])):
        for name in names:
            assert getattr(mod, name) == mod.COUNTS.get(name)
        with pytest.raises(AttributeError):
            mod.LAUNCHES_NONE
    before = tf.LAUNCHES_CM
    tf.COUNTS.add("LAUNCHES_CM")
    assert tf.LAUNCHES_CM == before + 1


# ---- on the card -------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 7])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_walked_window_on_card(cuda, cap, layout, n):
    """Forced caps on the card: one launch a sub-window, frames and carry
    of the un-walked launch and of the plain version."""
    k = 1 if layout == "i8" else 2
    planes, seg, carry, kw = _window(layout, 40 + n, W, 6, 9, True, k=k)
    for raster in (True, False):
        want, want_c = _port(layout, planes, seg, carry, raster=raster, **kw)
        one, one_c = _port(layout, planes, seg, carry, device=cuda, raster=raster, **kw)
        cap(n)
        before = tf.COUNTS.read()
        got, got_c = _port(layout, planes, seg, carry, device=cuda, raster=raster, **kw)
        cap(None)
        launched = {c: v - before[c] for c, v in tf.COUNTS.read().items() if v != before[c]}
        assert launched == {COUNTER[layout]: -(-W // n)}
        for f, c in ((got, got_c), (one, one_c)):
            np.testing.assert_array_equal(f, want)
            np.testing.assert_array_equal(c, want_c)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
def test_window_longer_than_a_launch_on_card(cuda, layout):
    """No wrapper raises above mj423_max_window() frames: 1,100 frames of
    2x4 blocks in two launches, byte-equal to the plain version."""
    w = _build.load().mj423_max_window() + 76
    planes, seg, carry, kw = _window(layout, 3, w, 2, 4, True)
    before = tf.COUNTS.get(COUNTER[layout])
    got, got_c = _port(layout, planes, seg, carry, device=cuda, raster=False, **kw)
    assert tf.COUNTS.get(COUNTER[layout]) == before + 2
    want, want_c = _port(layout, planes, seg, carry, raster=False, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_c, want_c)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["sharded3", "sharded_cm"])
def test_sharded_entries_take_long_shards_on_card(cuda, entry):
    """2 x 1,100 frames over a mesh that repeats the card: two launches a
    shard, frames equal to the CPU mesh's."""
    w = 2 * (_build.load().mj423_max_window() + 76)
    rng = np.random.default_rng(17)
    amps3 = rng.integers(-2047, 2048, (3, w, 8, 64), dtype=np.int16)
    seg = rng.random(w) < 0.02
    seg[[0, w // 2]] = True
    kw = dict(blocks_h=2, blocks_w=4, raster=True)
    if entry == "sharded3":
        fn, arg, counter = P.decode_transform_sharded3, amps3, "LAUNCHES"
    else:
        fn, arg, counter = P.decode_transform_sharded_cm, tf.to_cm(amps3, 2, 4, 1), "LAUNCHES_CM"
    before = tf.COUNTS.get(counter)
    got = fn(arg, seg, mesh=P.make_mesh(2, 1, devices=[cuda] * 2), **kw).numpy()
    assert tf.COUNTS.get(counter) == before + 4
    want = fn(arg, seg, mesh=P.make_mesh(2, 1, devices=["cpu"] * 2), **kw).numpy()
    np.testing.assert_array_equal(got, want)
