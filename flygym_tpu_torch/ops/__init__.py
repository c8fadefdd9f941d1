"""Hand-written CUDA kernels of the port and their wrappers."""

import torch


def checked_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`. The port's entry points run on
    the card unless the caller asks for the CPU, so a CUDA device without a
    card raises rather than falling back."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return device


def refuse_grad(name: str, *tensors) -> None:
    """Raise where grad mode is on and a tensor given to a CUDA kernel
    requires grad: the kernel's output would carry no graph, and the
    gradient would be cut without a word."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: this CUDA kernel has no gradient and would cut the graph; gradients "
            f"through the step come from the engine step of a differentiable model "
            f"(options['differentiable'] = True), whose contact solve runs the tree-LDL "
            f"kernels under autograd")
