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
