"""The physics engine on batch-first PyTorch tensors (port of ``flygym_tpu.engine``)."""
