"""Device resolution shared by every entry point of the port.

The port runs on the card unless the caller asks for the CPU: a request
for ``"cuda"`` on a host where ``torch.cuda.is_available()`` is false
raises instead of carrying on silently on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises ``RuntimeError`` for a
    CUDA device on a host with no usable card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the GPU by default and "
            "torch.cuda.is_available() is False; pass device='cpu' to "
            "run the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu'; got {device!r}")
    return dev
