"""PyTorch / CUDA port of the flygym-tpu physics engine.

The package mirrors ``flygym_tpu``'s layout, module for module, and is held
against it by the tests in ``tests/test_torch_*.py``. It imports neither JAX
nor ``flygym_tpu``: the compiled model reaches it as numpy data
(:mod:`flygym_tpu_torch.compose.bridge`).

Numerics policy: every engine tensor is float32, and TF32 is off for both
matmuls and cuDNN, so that a float32 product on the card keeps all of its
mantissa bits, as the JAX reference's CPU backend does.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from flygym_tpu_torch.batch import BatchSimulation  # noqa: E402
from flygym_tpu_torch.compose import load_compiled, model_from_numpy  # noqa: E402
from flygym_tpu_torch.simulation import Simulation  # noqa: E402

__all__ = ["BatchSimulation", "Simulation", "load_compiled", "model_from_numpy"]
