"""Device choice for the port's entry points."""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device=None) -> torch.device:
    """`cuda` unless the caller names another device.  A CUDA request where
    torch sees no card raises; nothing drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def synchronize(device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def describe(device) -> dict | str:
    """What a result ran on: "cpu", or the card's name, the count of cards
    and its power limit as nvidia-smi reports it ("not measured" where
    nvidia-smi gives nothing)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", str(index)],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return {"name": torch.cuda.get_device_name(index), "count": torch.cuda.device_count(),
            "power_limit": out or "not measured"}
