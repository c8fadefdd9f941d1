"""FlyGym 1.x → 2.x body-name translation.

Port of ``flygym_tpu/utils/api1to2.py`` (parity reference: flygym
``utils/api1to2.py:6-55``). Legacy names like
``LFTarsus1`` / ``Thorax`` / ``A1A2`` map to the 2.x ``{pos}_{link}`` scheme
(``lf_tarsus1`` / ``c_thorax`` / ``c_abdomen12``); legacy ``Femur`` maps to
the fused ``trochanterfemur`` segment.
"""

import re

__all__ = [
    "BODY_NAMES_OLD2NEW",
    "BODY_NAMES_NEW2OLD",
    "get_body_name_old2new_lookup",
    "get_body_name_new2old_lookup",
]

_CENTER = {
    "Thorax": "thorax",
    "Head": "head",
    "Rostrum": "rostrum",
    "Haustellum": "haustellum",
    "A1A2": "abdomen12",
    "A3": "abdomen3",
    "A4": "abdomen4",
    "A5": "abdomen5",
    "A6": "abdomen6",
}
_SIDED = ("Eye", "Pedicel", "Funiculus", "Arista", "Haltere", "Wing")
_LEG = ("Coxa", "Femur", "Tibia", "Tarsus1", "Tarsus2", "Tarsus3", "Tarsus4", "Tarsus5")


def _old2new(old_name: str) -> str:
    if old_name in _CENTER:
        return f"c_{_CENTER[old_name]}"
    if m := re.fullmatch(r"([LR][FMH])(\w+)", old_name):
        leg, seg = m.groups()
        if seg in _LEG:
            link = "trochanterfemur" if seg == "Femur" else seg.lower()
            return f"{leg.lower()}_{link}"
    if m := re.fullmatch(r"([LR])(\w+)", old_name):
        side, seg = m.groups()
        if seg in _SIDED:
            return f"{side.lower()}_{seg.lower()}"
    raise ValueError(f"Unknown legacy body name: {old_name}")


_OLD_NAMES = [
    *_CENTER,
    *(f"{side}{seg}" for side in "LR" for seg in _SIDED),
    *(f"{side}{pos}{seg}" for side in "LR" for pos in "FMH" for seg in _LEG),
]

BODY_NAMES_OLD2NEW = {old: _old2new(old) for old in _OLD_NAMES}
BODY_NAMES_NEW2OLD = {new: old for old, new in BODY_NAMES_OLD2NEW.items()}


def get_body_name_old2new_lookup() -> dict:
    """Legacy (1.x) body name → 2.x body name."""
    return BODY_NAMES_OLD2NEW


def get_body_name_new2old_lookup() -> dict:
    """2.x body name → legacy (1.x) body name."""
    return BODY_NAMES_NEW2OLD
