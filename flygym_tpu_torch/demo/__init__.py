"""The replay benchmark of the Spotlight walking clip, and the examples.

Port of ``flygym_tpu/demo/__init__.py``: ``MotionSnippet``, ``make_model``,
``run_benchmark`` and ``ReplayTargetData`` load lazily, so that importing
one example does not import the benchmark's stack.
"""

_LAZY = {
    "MotionSnippet": "flygym_tpu_torch.demo.spotlight",
    "make_model": "flygym_tpu_torch.demo.benchmark",
    "run_benchmark": "flygym_tpu_torch.demo.benchmark",
    "ReplayTargetData": "flygym_tpu_torch.demo.benchmark",
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'flygym_tpu_torch.demo' has no attribute {name!r}")
