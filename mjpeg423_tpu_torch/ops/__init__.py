"""Device ops of the port: plain PyTorch versions and the CUDA kernel wrappers."""
from __future__ import annotations

import torch

from ._counters import launch_counts, reset_counts  # noqa: F401


def resolve_device(device, use_pallas: bool | None = None) -> torch.device:
    """The torch device an entry point runs on: cpu (the plain PyTorch
    path, asked for by name) or cuda (the kernels), never a fallback from
    one to the other.  A bare "cuda" resolves to the current card.
    use_pallas, the JAX entry points' kernel switch, must agree with the
    device when it is given: the port runs its kernels exactly on CUDA."""
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"device must be cpu or cuda, got {dev}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device is cuda but torch.cuda.is_available() is false; "
                "pass device='cpu' to run the plain PyTorch path"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    if use_pallas is not None and use_pallas != (dev.type == "cuda"):
        raise ValueError(
            f"use_pallas={use_pallas} contradicts device {dev}: the port "
            "runs the kernel exactly when the device is CUDA"
        )
    return dev
