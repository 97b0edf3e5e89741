"""Generic name -> object registry (port of ``pytorchrec_tpu/utils/registry.py``):
the readers' registry (``data/readers/__init__.py``) is one.
"""

from __future__ import annotations

from typing import Callable, Dict, Generic, Iterable, Optional, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, T] = {}

    def register(self, name: str, obj: Optional[T] = None) -> Callable[[T], T]:
        """Register directly or as a decorator: ``@registry.register("name")``."""
        key = name.lower()

        def _do(o: T) -> T:
            if key in self._entries:
                raise KeyError(f"{self.kind} {name!r} already registered")
            self._entries[key] = o
            return o

        if obj is not None:
            return _do(obj)
        return _do

    def get(self, name: str) -> T:
        key = str(name).lower()
        if key not in self._entries:
            raise ValueError(
                f"unknown {self.kind} {name!r}; available: {sorted(self._entries)}"
            )
        return self._entries[key]

    def names(self) -> Iterable[str]:
        return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        return str(name).lower() in self._entries
