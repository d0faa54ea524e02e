"""Global registry of models / datasets / tasks / lr schedules (the port's
own copy of ``situation3d_tpu/utils/registry.py``): one class-level mapping
with typed namespaces and decorator registration.
"""
from __future__ import annotations

from typing import Any, Callable, Dict


class Registry:
    _groups: Dict[str, Dict[str, Any]] = {}

    def _group(self, kind: str) -> Dict[str, Any]:
        return self._groups.setdefault(kind, {})

    def register(self, kind: str, name: str) -> Callable:
        def deco(obj):
            group = self._group(kind)
            if name in group and group[name] is not obj:
                raise KeyError(f"{kind}:{name} already registered to {group[name]!r}")
            group[name] = obj
            return obj
        return deco

    # convenience namespaces (mirrors registry.register_model / register_task ...)
    def register_model(self, name: str) -> Callable:
        return self.register("model", name)

    def register_dataset(self, name: str) -> Callable:
        return self.register("dataset", name)

    def register_task(self, name: str) -> Callable:
        return self.register("task", name)

    def register_lr_schedule(self, name: str) -> Callable:
        return self.register("lr_schedule", name)

    def get(self, kind: str, name: str) -> Any:
        group = self._group(kind)
        if name not in group:
            raise KeyError(f"Unknown {kind} {name!r}; registered: {sorted(group)}")
        return group[name]

    def get_model(self, name: str) -> Any:
        return self.get("model", name)

    def get_dataset(self, name: str) -> Any:
        return self.get("dataset", name)

    def get_task(self, name: str) -> Any:
        return self.get("task", name)

    def list(self, kind: str):
        return sorted(self._group(kind))


registry = Registry()
