"""Plotting helpers: a TrueType font for image overlays.

Port of ``flygym_tpu/utils/plot.py`` (parity reference: flygym
``utils/plot.py:1-19``).
"""

from pathlib import Path

__all__ = ["find_font"]

_FONT_DIRS = [
    Path("/usr/share/fonts"),
    Path("/usr/local/share/fonts"),
    Path.home() / ".fonts",
]


def find_font(preferred: str = "DejaVuSans") -> str | None:
    """A path to a TTF font, the first whose name holds ``preferred``
    (any case), else the first found, else None."""
    candidates = []
    for base in _FONT_DIRS:
        if base.is_dir():
            candidates.extend(base.rglob("*.ttf"))
    for path in candidates:
        if preferred.lower() in path.stem.lower():
            return str(path)
    return str(candidates[0]) if candidates else None
