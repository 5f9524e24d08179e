"""Top-level entry points of the port: the single-device decode step and a
multi-device dry run.  The counterpart of the repository's
__graft_entry__.py.

entry(device)            -> (fn, example_args): the forward decode step of
                            the main path, the fused decode window (K1 on
                            CUDA, its plain version on the CPU).
dryrun_multichip(n)      -> runs the five sharded passes of the JAX dry run
                            on an n-device (data, block) mesh at tiny
                            shapes, each held byte for byte against a
                            single-device decode or the host encoder, and
                            returns each pass's kernel launches.

    python -m mjpeg423_tpu_torch.entry      # entry() and a 4-device dry run
                                            # on the card
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .ops import launch_counts, resolve_device, transform, transform_fused


def entry(device="cuda"):
    """Return (fn, example_args) for the single-device forward decode step.

    Shapes model one GOP of 640x480, as the JAX entry's do: 24 frames x
    4,800 blocks a plane, amplitudes from default_rng(0) in [-64, 64), an
    I-frame at 0 and a zero carry.  fn(amps, is_iframe, carry) returns
    (raster frames (24, 480, 640) uint32, new carry (3, 4800, 64) int16).
    device="cuda" (the default) needs a card; "cpu" runs the plain version
    and must be asked for by name.
    """
    dev = resolve_device(device)
    f, b = 24, 4800  # 640x480: (480/8)*(640/8) blocks
    rng = np.random.default_rng(0)
    amps = rng.integers(-64, 64, size=(3, f, b, 64)).astype(np.int16)
    is_iframe = np.zeros(f, dtype=bool)
    is_iframe[0] = True
    fn = functools.partial(transform_fused.decode_window_fused,
                           blocks_h=60, blocks_w=80)
    args = (torch.from_numpy(amps).to(dev), torch.from_numpy(is_iframe).to(dev),
            torch.zeros((3, b, 64), dtype=torch.int16, device=dev))
    return fn, args


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def _default_devices(n: int) -> list[torch.device]:
    """The first n cards, or cuda:0 repeated n times where there are fewer
    (the sharded code on one card); no default without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "dryrun_multichip needs a CUDA device; pass devices= (for "
            "example ['cpu'] * n) to run it elsewhere"
        )
    if torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cuda", 0)] * n


def dryrun_multichip(n_devices: int, devices=None) -> dict[str, dict]:
    """Run the sharded decode and encode paths on an n-device mesh.

    The five passes of the JAX dry run, on its shapes and seeds, each
    byte-equal where the JAX one checks shapes only:
      1. decode_transform_sharded unaligned (the cross-shard carry) with
         the plain transform, against a single-device plain decode; on
         CUDA devices once more with the kernels (K5 where the data axis
         has more than one shard);
      2. GOP-aligned with the kernel (K1 per shard), against the same;
      3. DecodePipeline(mesh=) on a 16x16 container, against the NumPy
         decoder (codec/decoder.decode_stream_array);
      4. encode_frames_device(mesh=, use_pallas=False), the candidate path,
         against the host encoder's container;
      5. encode_frames_device(mesh=) on the fused path (K4 per shard),
         against the same bytes.
    devices: n devices for the mesh (default: _default_devices).  Returns
    each pass's kernel launches, {"1": {"K1": .., "K5": ..}, ...}; the CPU
    launches nothing.
    """
    from .codec import decoder, encoder
    from .parallel import decode_transform_sharded, make_mesh, shard_inputs
    from .runtime import DecodeConfig, DecodePipeline

    devices = ([torch.device(d) for d in devices] if devices is not None
               else _default_devices(n_devices))
    if len(devices) != n_devices:
        raise ValueError(f"need {n_devices} devices, got {len(devices)}")
    on_cuda = all(d.type == "cuda" for d in devices)
    launches: dict[str, dict] = {}

    def counted(name: str, fn):
        before = launch_counts()
        out = fn()
        after = launch_counts()
        launches[name] = {k: after[k] - before[k] for k in after
                          if after[k] != before[k]}
        return out

    # Split devices over (data, block): the block axis gets 2 when it can,
    # so both shardings (and the raster row split) run.
    n_block = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    n_data = n_devices // n_block
    mesh = make_mesh(n_data, n_block, devices=devices)

    # Tiny shapes: F divisible by n_data, blocks_h divisible by n_block.
    f = 2 * n_data
    blocks_h = 2 * n_block
    blocks_w = 4
    b = blocks_h * blocks_w
    geom = dict(blocks_h=blocks_h, blocks_w=blocks_w)
    rng = np.random.default_rng(1)
    amps = rng.integers(-32, 32, size=(3, f, b, 64)).astype(np.int16)

    def single_device(seg: np.ndarray) -> np.ndarray:
        return transform.decode_transform(
            *torch.from_numpy(amps), torch.from_numpy(seg), **geom
        ).numpy()

    # Pass 1: the unaligned step, the cross-shard carry.
    seg = np.zeros(f, dtype=bool)
    seg[0] = True
    seg[f // 2] = True  # mid-stream I-frame, not shard-aligned
    want = single_device(seg)
    args = shard_inputs(mesh, amps[0], amps[1], amps[2], seg)
    for name, kernel in (("1", False), ("1 kernels", True)):
        if kernel and not on_cuda:
            continue
        out = counted(name, lambda: decode_transform_sharded(
            *args, mesh=mesh, gop_aligned=False, use_pallas=kernel,
            **geom).numpy())
        _require(out.shape == (f, blocks_h * 8, blocks_w * 8)
                 and np.array_equal(out, want),
                 f"pass {name}: sharded decode differs from one device")

    # Pass 2: the fused kernel on GOP-aligned shards.
    seg2 = np.zeros(f, dtype=bool)
    seg2[:: f // n_data] = True  # every data shard starts with an I-frame
    args2 = shard_inputs(mesh, amps[0], amps[1], amps[2], seg2)
    out2 = counted("2", lambda: decode_transform_sharded(
        *args2, mesh=mesh, gop_aligned=True, use_pallas=True, **geom).numpy())
    _require(np.array_equal(out2, single_device(seg2)),
             "pass 2: GOP-aligned sharded decode differs from one device")

    # Pass 3: the mesh streaming pipeline on a real container.
    frames_rgb = [
        rng.integers(0, 256, size=(16, 16, 3)).astype(np.uint8)
        for _ in range(2 * n_devices)
    ]
    data = encoder.encode_frames(frames_rgb, max_i_interval=2)
    line = make_mesh(n_devices, 1, devices=devices)
    got = counted("3", lambda: DecodePipeline(
        DecodeConfig(frames_per_batch=2), mesh=line).decode_array(data))
    _require(np.array_equal(got, decoder.decode_stream_array(data)),
             "pass 3: mesh pipeline differs from the NumPy decoder")

    # Pass 4: the sharded candidate encoder (one halo copy a shard).
    sharded = counted("4", lambda: encoder.encode_frames_device(
        frames_rgb, max_i_interval=2, mesh=line, use_pallas=False))
    _require(sharded == data, "pass 4: sharded candidate encoder container")

    # Pass 5: the fused encoder sharded over "data", no exchange.
    fused = counted("5", lambda: encoder.encode_frames_device(
        frames_rgb, max_i_interval=2, mesh=line,
        use_pallas=True if on_cuda else None))
    _require(fused == data, "pass 5: sharded fused encoder container")
    return launches


if __name__ == "__main__":
    import json

    fn, args = entry()
    frames, carry = fn(*args)
    torch.cuda.synchronize()
    print(f"entry: frames {tuple(frames.shape)} {frames.dtype}, carry "
          f"{tuple(carry.shape)} {carry.dtype} on {frames.device}")
    print(f"dryrun_multichip(4): ok, launches {json.dumps(dryrun_multichip(4))}")
