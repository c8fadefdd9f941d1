"""Internal exception types.

Port of ``flygym_tpu/utils/exceptions.py``.

Parity reference: flygym ``utils/exceptions.py:4-7``.
"""

__all__ = ["FlyGymInternalError"]


class FlyGymInternalError(Exception):
    """Raised when an internal invariant of the framework is violated.

    If you see this, it is a bug in the framework itself rather than user error.
    """
