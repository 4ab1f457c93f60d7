"""Hand-written CUDA kernels (sources in ``repro_torch/csrc/``), each beside
its plain PyTorch version and a launch counter; built on first CUDA use.

No kernel has a backward, so a wrapper refuses an input that autograd would
record through it (``refuse_grad``): the output would have no ``grad_fn``
and the gradient of everything before it would be lost without an error.

Under a dry-run (``launch/dryrun.py``) the wrappers see fake tensors: each
takes its fake branch first (``is_fake``, before its CPU branch and before
any ``torch.cuda`` call), which launches nothing and bumps no ``.launches``
counter, returns an empty output of the kernel's shape and dtype, and adds
the kernel's ``KernelSpec.cost`` to the running count (``fake_launch``). A
real tensor never takes that branch; a fake tensor outside a count
raises."""
from __future__ import annotations

import sys

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


def is_fake(t: torch.Tensor) -> bool:
    """Whether t is a ``FakeTensor`` (a dry-run's: no storage, no data)."""
    fake = sys.modules.get("torch._subclasses.fake_tensor")
    return fake is not None and isinstance(t, fake.FakeTensor)


def fake_launch(kernel: str, out, shape: dict, **cost_kw):
    """A wrapper's fake branch: the kernel's ``KernelSpec.cost`` at
    ``shape`` (``core/provision/autotune.py``'s ``KERNELS[kernel]``, with
    ``cost_kw``) recorded by the running count, and ``out`` returned
    (empty tensors of the kernel's outputs); raises when no count runs."""
    from repro_torch.roofline import op_cost
    op_cost.record_kernel(kernel, shape, **cost_kw)
    return out


def dtype_name(dtype: torch.dtype) -> str:
    """"bfloat16" for torch.bfloat16: the dtype key of a kernel's shape."""
    return str(dtype).removeprefix("torch.")
