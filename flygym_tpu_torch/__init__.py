"""PyTorch / CUDA port of the flygym-tpu physics engine.

The package mirrors ``flygym_tpu``'s layout, module for module, and is held
against it by the tests in ``tests/test_torch_*.py``. It imports neither JAX
nor ``flygym_tpu``. A world is composed and compiled by the port's own
composition layer (:mod:`flygym_tpu_torch.compose`: ``Fly``, the worlds,
``ModelSpec.compile``), or loaded from an ``.npz`` file that the JAX package
exported (:mod:`flygym_tpu_torch.compose.bridge`); both reach the engine
through :func:`~flygym_tpu_torch.compose.bridge.model_from_numpy`.

Numerics policy: every engine tensor is float32, and TF32 is off for both
matmuls and cuDNN, so that a float32 product on the card keeps all of its
mantissa bits, as the JAX reference's CPU backend does.
"""

from pathlib import Path

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# The port's own copies of the model assets (rigging, derived geometry,
# visuals, poses, mesh SDFs, the Spotlight clip) and the exported worlds.
assets_dir = Path(__file__).parent / "assets"

from flygym_tpu_torch import anatomy  # noqa: E402
from flygym_tpu_torch.batch import BatchSimulation  # noqa: E402
from flygym_tpu_torch.compose import load_compiled, model_from_numpy  # noqa: E402
from flygym_tpu_torch.simulation import Simulation  # noqa: E402

__all__ = ["BatchSimulation", "Simulation", "anatomy", "assets_dir", "load_compiled",
           "model_from_numpy"]
