"""Running the plain step at the timed sizes, and the controls.

:func:`plain_chain` runs K chained plain steps (:func:`~portbench.reference.
emitter.megastep_plain`). A plain step is some 300,000 small operations; on
the CPU they run eagerly, on the card one step is captured in a CUDA graph
and replayed once per step, each replay's state copied into the next one's
inputs: the same operations on the same values as the eager chain, so the
same bits, at a card's time per step rather than the host's (the port's
``chip_smoke.py:plain_steps`` does the same).

The controls put a lower precision in the reference's place:
:class:`Bfloat16` rounds every float32 result of a torch function to
bfloat16 (arithmetic in bfloat16, as a kernel that computes in float32 and
stores bfloat16 would round), and :func:`tf32` lets float32 matrix
products run in TF32.
"""

import contextlib
from dataclasses import replace

import torch
from torch.overrides import TorchFunctionMode

from portbench.reference import emitter
from portbench.reference.maths import powf

__all__ = ["CONTROLS", "Bfloat16", "plain_chain", "precision", "tf32"]

CONTROLS = ("bfloat16", "tf32")

_CARRIED = ("qpos", "qvel", "act", "qacc")


class Bfloat16(TorchFunctionMode):
    """Every float32 tensor a torch function returns, rounded to bfloat16
    (and kept as float32)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if isinstance(out, torch.Tensor) and out.dtype == torch.float32:
            return out.to(torch.bfloat16).to(torch.float32)
        return out


@contextlib.contextmanager
def tf32():
    """float32 matrix products in TF32 inside the block."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def precision(control=None):
    """The context the reference computes in: float32 (``None``), or a
    control, ``"bfloat16"`` or ``"tf32"``."""
    if control is None:
        return contextlib.nullcontext()
    if control == "bfloat16":
        return Bfloat16()
    if control == "tf32":
        return tf32()
    raise ValueError(f"unknown control {control!r}; one of {CONTROLS}")


def plain_chain(static, state, seq, control=None):
    """K plain steps from ``state`` with the (K, B, nu) controls ``seq``:
    ``(state after the K steps, (K, B, nq) qpos rows)``, what one K-step
    launch of K2 returns, computed in :func:`precision` ``(control)``. One
    step runs eagerly: a capture costs as much as an eager step."""
    with torch.inference_mode():
        if state.qpos.device.type != "cuda" or len(seq) == 1:
            with precision(control):
                return emitter.megastep_plain(static, state, seq)
        powf(state.qpos[:1, :1].abs(), 2.0)  # its tables are made before the capture
        inp = replace(state, ctrl=seq[0].clone(),
                      **{f: getattr(state, f).clone() for f in _CARRIED})
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph), precision(control):
            out = emitter.megastep_plain(static, inp, None)
        rows = []
        for i in range(len(seq)):
            if i:
                inp.ctrl.copy_(seq[i])
                for f in _CARRIED:
                    getattr(inp, f).copy_(getattr(out, f))
            graph.replay()
            rows.append(out.qpos.clone())
        new = replace(out.map(torch.clone), ctrl=seq[-1],
                      time=state.time + len(seq) * static.timestep)
        del graph, out
        return new, torch.stack(rows)
