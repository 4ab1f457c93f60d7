"""Hand-written CUDA kernels (sources in ``repro_torch/csrc/``), each beside
its plain PyTorch version and a launch counter; built on first CUDA use.

No kernel has a backward, so a wrapper refuses an input that autograd would
record through it (``refuse_grad``): the output would have no ``grad_fn``
and the gradient of everything before it would be lost without an error."""
from __future__ import annotations

import torch


def refuse_grad(kernel: str, plain: str, *tensors) -> None:
    """Raise when grad mode is on and any of ``tensors`` requires grad. It
    raises on every device, the CPU's plain path included, so that code
    which would cut a graph on the card fails on the CPU too."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} has no backward: an input requires grad, and its "
            f"output would cut the autograd graph. Differentiate the plain "
            f"version ({plain}) instead, or call it under torch.no_grad(); "
            "the model's train mode takes blocks.train_attention")
