"""Locomotor controllers, batched over worlds: the CPG, the hybrid
controller and the visual taxis controller (port of ``flygym_tpu/control``)."""

from flygym_tpu_torch.control.cpg import (
    CPGController,
    CPGNetwork,
    CPGState,
    extract_preprogrammed_steps,
    tripod_phase_biases,
)
from flygym_tpu_torch.control.hybrid import HybridController, HybridState
from flygym_tpu_torch.control.taxis import VisualTaxisController, object_azimuth_drive

__all__ = [
    "CPGController",
    "CPGNetwork",
    "CPGState",
    "extract_preprogrammed_steps",
    "tripod_phase_biases",
    "HybridController",
    "HybridState",
    "VisualTaxisController",
    "object_azimuth_drive",
]
