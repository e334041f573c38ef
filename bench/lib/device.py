"""The few calls that differ between the card and the CPU (the CPU is for
the harness's own tests at small sizes)."""
from __future__ import annotations

import torch


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


def release(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.empty_cache()
