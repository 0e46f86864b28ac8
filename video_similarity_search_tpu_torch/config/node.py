"""A minimal attribute-style config node with YAML / dotted-list merging.

Fresh implementation of the capability the reference gets from
``fvcore.common.config.CfgNode`` (used at reference
config/default_params.py:5 and config/m_parser.py:164-174): nested
attribute access, ``clone()``, ``merge_from_file(yaml)`` and
``merge_from_list([KEY.SUBKEY, value, ...])`` with type coercion.

The port's copy of the JAX package's ``config/node.py``. ``yaml`` is
imported only where a file is read or written, so the port runs on a
machine without pyyaml as long as it merges from lists.
"""

from __future__ import annotations

import ast
import copy
from typing import Any


class ConfigNode(dict):
    """dict subclass with attribute access and recursive merge."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def clone(self) -> "ConfigNode":
        return copy.deepcopy(self)

    # -- merging ----------------------------------------------------------
    def merge_from_other(self, other: dict) -> None:
        for key, value in other.items():
            if isinstance(value, dict) and isinstance(self.get(key), ConfigNode):
                self[key].merge_from_other(value)
            else:
                if key in self:
                    value = _coerce(value, self[key])
                self[key] = _wrap(value)

    def merge_from_file(self, path: str) -> None:
        import yaml

        with open(path) as f:
            loaded = yaml.safe_load(f) or {}
        self.merge_from_other(loaded)

    def merge_from_list(self, opts: list) -> None:
        assert len(opts) % 2 == 0, f"Override list has odd length: {opts}"
        for full_key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = full_key.split(".")
            for part in parts[:-1]:
                node = node[part]
            leaf = parts[-1]
            if isinstance(value, str):
                value = _decode_str(value)
            if leaf in node:
                value = _coerce(value, node[leaf])
            node[leaf] = value

    def to_dict(self) -> dict:
        return {
            k: v.to_dict() if isinstance(v, ConfigNode) else v for k, v in self.items()
        }

    def dump(self) -> str:
        import yaml

        return yaml.safe_dump(self.to_dict(), sort_keys=False)


def _wrap(value: Any) -> Any:
    if isinstance(value, dict) and not isinstance(value, ConfigNode):
        node = ConfigNode()
        for k, v in value.items():
            node[k] = _wrap(v)
        return node
    return value


def _decode_str(s: str) -> Any:
    """Interpret CLI-style string values: literals where possible."""
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


def _coerce(new: Any, old: Any) -> Any:
    """Coerce a merged value to the existing value's type when sensible."""
    if old is None or new is None:
        return new
    if isinstance(old, bool) and isinstance(new, (int, str)):
        if isinstance(new, str):
            low = new.lower()
            if low in ("true", "1", "yes"):
                return True
            if low in ("false", "0", "no"):
                return False
            return new
        return bool(new)
    if isinstance(old, float) and isinstance(new, int):
        return float(new)
    if isinstance(old, (int, float, str, bool)) and type(new) is type(old):
        return new
    return new
