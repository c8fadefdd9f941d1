"""Checkpoints and performance reports (``flygym_tpu/utils``' counterparts)."""
