"""Enum helpers (port of ``pytorchrec_tpu/utils/enum_utils.py``)."""

from __future__ import annotations

from enum import Enum
from typing import List, Type


def get_enum_values(enum_type: Type[Enum]) -> List:
    return [member.value for member in enum_type]
