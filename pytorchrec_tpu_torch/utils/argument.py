"""Typed, self-validating flags (port of ``pytorchrec_tpu/utils/argument.py``,
the same behaviour): components declare their own typed and bounded flags
and check values against them; a description adds itself to an
``argparse`` parser for the CLI.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional, Sequence


def str2bool(value) -> bool:
    if isinstance(value, bool):
        return value
    if str(value).lower() in ("yes", "true", "t", "y", "1"):
        return True
    if str(value).lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(f"boolean value expected, got {value!r}")


class ArgumentDescription:
    """A typed flag spec with bounds / legal values / default."""

    def __init__(
        self,
        name: str,
        type_: type,
        help_info: str = "",
        default_value: Any = None,
        legal_value_list: Optional[Sequence[Any]] = None,
        lower_closed_bound: Any = None,
        lower_open_bound: Any = None,
        upper_closed_bound: Any = None,
        upper_open_bound: Any = None,
    ):
        self.name = name
        self.type = type_
        self.help_info = help_info
        self.default_value = default_value
        self.legal_value_list = list(legal_value_list) if legal_value_list is not None else None
        self.lower_closed_bound = lower_closed_bound
        self.lower_open_bound = lower_open_bound
        self.upper_closed_bound = upper_closed_bound
        self.upper_open_bound = upper_open_bound

    def check_value(self, value: Any) -> None:
        if value is None:
            if self.default_value is None:
                raise ValueError(f"argument --{self.name} is required")
            return
        if self.legal_value_list is not None and value not in self.legal_value_list:
            raise ValueError(f"--{self.name}={value!r} not in legal values {self.legal_value_list}")
        if self.lower_closed_bound is not None and value < self.lower_closed_bound:
            raise ValueError(f"--{self.name}={value!r} must be >= {self.lower_closed_bound}")
        if self.lower_open_bound is not None and value <= self.lower_open_bound:
            raise ValueError(f"--{self.name}={value!r} must be > {self.lower_open_bound}")
        if self.upper_closed_bound is not None and value > self.upper_closed_bound:
            raise ValueError(f"--{self.name}={value!r} must be <= {self.upper_closed_bound}")
        if self.upper_open_bound is not None and value >= self.upper_open_bound:
            raise ValueError(f"--{self.name}={value!r} must be < {self.upper_open_bound}")

    def add_argument_into_argparser(self, parser: argparse.ArgumentParser) -> None:
        type_fn = str2bool if self.type is bool else self.type
        kwargs: Dict[str, Any] = {"type": type_fn, "help": self.help_info}
        if self.default_value is not None:
            kwargs["default"] = self.default_value
        if self.legal_value_list is not None:
            kwargs["choices"] = self.legal_value_list
        parser.add_argument(f"--{self.name}", **kwargs)

    def __repr__(self):
        return f"ArgumentDescription(name={self.name!r}, type={self.type.__name__}, default={self.default_value!r})"


class WithArguments:
    """Mixin: classes declare and check their own flags."""

    @classmethod
    def get_argument_descriptions(cls) -> List[ArgumentDescription]:
        return []

    @classmethod
    def check_argument_values(cls, arguments: Dict[str, Any]) -> None:
        for description in cls.get_argument_descriptions() or []:
            if description.name in arguments:
                description.check_value(arguments[description.name])
            elif description.default_value is not None:
                arguments[description.name] = description.default_value
            else:
                raise ValueError(f"missing required argument --{description.name}")
