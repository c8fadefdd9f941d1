"""Locomotor controllers, batched over worlds: the CPG and the hybrid
controller (port of ``flygym_tpu/control``; the visual taxis controller is
not ported yet)."""

from flygym_tpu_torch.control.cpg import (
    CPGController,
    CPGNetwork,
    CPGState,
    extract_preprogrammed_steps,
    tripod_phase_biases,
)
from flygym_tpu_torch.control.hybrid import HybridController, HybridState

__all__ = [
    "CPGController",
    "CPGNetwork",
    "CPGState",
    "extract_preprogrammed_steps",
    "tripod_phase_biases",
    "HybridController",
    "HybridState",
]
