"""Device resolution for the port's entry points.

``None`` means the first CUDA card; with no card it raises instead of
quietly running on the CPU. The CPU is used only when asked for by name.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda:0`` (raises without CUDA); anything else is taken
    as given (``"cpu"``, ``"cuda:1"``, a ``torch.device``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port on the CPU explicitly"
            )
        return torch.device("cuda", 0)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is unavailable")
    return device


BACKENDS = ("auto", "torch", "cuda")


def resolve_backend(backend: str, device) -> str:
    """Normalize the ``auto | torch | cuda`` kernel knob for tensors on
    ``device`` (a ``torch.device`` or a tensor): ``auto`` picks the CUDA
    kernels for a CUDA tensor and the plain versions for a CPU one."""
    if backend not in BACKENDS:
        raise ValueError(
            f"attention_backend must be one of {BACKENDS}, got {backend!r}"
        )
    if backend != "auto":
        return backend
    dev = device.device if isinstance(device, torch.Tensor) else torch.device(device)
    return "cuda" if dev.type == "cuda" else "torch"
