"""JSON-backed configuration objects with attribute access.

Counterpart of learninghumanoidwalking_tpu/utils/config.py: a recursive
dict -> attribute view where missing attributes read as None, so env code
can write ``cfg.task.goal_height`` and probe optional blocks like
``cfg.dynamics_randomization``. The port stores its configs as JSON (the
standard library reads them), not YAML.
"""

from __future__ import annotations

import json
from typing import Any


class Configuration:
    """Recursive attribute-access view over a dict; missing keys read None."""

    def __init__(self, data: dict | None = None):
        self._data: dict[str, Any] = {}
        if data:
            for key, value in data.items():
                self._data[key] = self._wrap(value)

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, dict):
            return Configuration(value)
        if isinstance(value, list):
            return [Configuration._wrap(v) for v in value]
        return value

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        return self._data.get(name, None)

    def to_dict(self) -> dict:
        """The plain dict (nested Configurations unwrapped)."""
        unwrap = lambda v: v.to_dict() if isinstance(v, Configuration) else [unwrap(x) for x in v] if isinstance(v, list) else v
        return {k: unwrap(v) for k, v in self._data.items()}

    def __repr__(self) -> str:
        return f"Configuration({self._data!r})"


def load_json(path: str) -> Configuration:
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict):
        raise ValueError(f"Top-level JSON structure in {path} must be an object")
    return Configuration(data)
