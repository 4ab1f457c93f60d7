"""PyTorch and CUDA port of the ``repro`` compute stack for one NVIDIA H100.

The JAX package ``repro`` stays the reference; this package mirrors its
layout (``configs/``, ``kernels/``, ``models/``, ``serve/``, ``launch/``)
and imports nothing from it. Entry points run on ``"cuda"`` unless the
caller passes ``device="cpu"``; on the CPU every kernel wrapper takes its
plain PyTorch version. Kernels are built on first CUDA use, never at import.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; raises when CUDA is asked for and
    absent, so a run never carries on silently on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch sees no CUDA "
                "device; pass device='cpu' to run the plain versions")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev
