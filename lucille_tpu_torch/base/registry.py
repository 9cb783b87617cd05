"""Name-keyed driver registries.

Equivalent capability to lucille's string-hash driver registries
(src/render/render.c:186-187, 224-279): display drivers, geometry parsers
and acceleration structures are registered by name and looked up at
scene-setup time, with a fallback chain for unknown names
(render.c:430-513).

The port's copy of lucille_tpu/base/registry.py: the same code, with its
imports pointed at lucille_tpu_torch's own host modules.
"""

from __future__ import annotations

from typing import Callable, Generic, TypeVar

from lucille_tpu_torch.base.log import LOG_WARN, log_once

T = TypeVar("T")


class Registry(Generic[T]):
    def __init__(self, kind: str):
        self._kind = kind
        self._entries: dict[str, T] = {}

    def register(self, name: str, entry: T) -> None:
        self._entries[name.lower()] = entry

    def lookup(self, name: str, fallback: str | None = None) -> T | None:
        entry = self._entries.get(name.lower())
        if entry is None and fallback is not None:
            log_once(
                LOG_WARN,
                "unknown %s driver '%s'; falling back to '%s'",
                self._kind,
                name,
                fallback,
            )
            entry = self._entries.get(fallback.lower())
        return entry

    def names(self) -> list[str]:
        return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        return name.lower() in self._entries


def registry_of(kind: str) -> Callable[[], Registry]:
    return lambda: Registry(kind)
