"""Loading compiled models exported from the JAX package."""

from flygym_tpu_torch.compose.bridge import CompiledModel, load_compiled, model_from_numpy

__all__ = ["CompiledModel", "load_compiled", "model_from_numpy"]
