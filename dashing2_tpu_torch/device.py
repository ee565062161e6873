"""Device selection: the caller names the device; nothing falls back.

The port has no module-level device state. Every entry point takes a
`device` argument ("cuda", "cuda:1", "cpu"); a CUDA request on a machine
where torch sees no card raises here instead of running on the CPU.
"""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} was requested but torch sees no CUDA card "
            "(use --device cpu for the plain PyTorch versions)")
    return dev


def synchronize(dev: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
