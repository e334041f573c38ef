"""Device resolution and the runner fingerprint.

Entry points of the port run on the card unless the caller asks for the
CPU: `resolve_device(None)` means CUDA, and raises when no GPU is present
instead of carrying on on the CPU. Kernel dispatch itself never consults
this module: `repro_torch.kernels.ops` decides by the tensor's device.
"""
from __future__ import annotations

import os
import platform
import subprocess
from typing import Dict, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def on_cuda() -> bool:
    return torch.cuda.is_available()


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` -> the card. A CUDA device without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def check_device(t: torch.Tensor, device: torch.device, what: str) -> None:
    """Raise unless tensor `t` lives on `device` (index-insensitive for a
    bare 'cuda')."""
    if t.device.type != device.type or (
        device.index is not None and t.device.index != device.index
    ):
        raise ValueError(f"{what} lives on {t.device}, expected {device}")


def power_limit() -> Optional[str]:
    """The card's name and power limit as `nvidia-smi` reports them, or
    None where there is no `nvidia-smi`."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def runner_fingerprint() -> Dict[str, object]:
    """Identity of the machine a measurement ran on. `device_kind` (with
    the power limit beside it) is the comparability key: numbers from
    different cards, or from the CPU, are not comparable."""
    fp: Dict[str, object] = {
        "kernel_backend": "cuda" if on_cuda() else "plain-cpu",
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "platform": platform.platform(),
        "python": platform.python_version(),
        "cpu_count": os.cpu_count(),
    }
    if on_cuda():
        fp.update(
            device_kind=torch.cuda.get_device_name(0),
            device_count=torch.cuda.device_count(),
            compute_capability=".".join(
                str(v) for v in torch.cuda.get_device_capability(0)
            ),
            nvidia_smi=power_limit(),
        )
    else:
        fp.update(device_kind="cpu", device_count=0)
    return fp
