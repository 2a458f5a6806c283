"""Schema-in-code configuration with choice constraints and CLI overrides.

Port of ``erc_tpu.core.params``: attribute-style schema with defaults
declared in ``__init__``, ``choice()`` constraints enforced on every
assignment, and dotted-key CLI overrides (``--train.batch_size=8``).
"""

from __future__ import annotations

import json
import sys
from typing import Any, Optional


def _parse_value(raw: str) -> Any:
    """Parse a CLI string into bool/int/float/str/None/json."""
    low = raw.lower()
    if low in ("true", "yes"):
        return True
    if low in ("false", "no"):
        return False
    if low in ("none", "null"):
        return None
    for cast in (int, float):
        try:
            return cast(raw)
        except ValueError:
            pass
    if raw[:1] in "[{":
        try:
            return json.loads(raw)
        except json.JSONDecodeError:
            pass
    return raw


class Choice:
    """A value constrained to a fixed option set."""

    __slots__ = ("value", "options")

    def __init__(self, default: Any, options: tuple):
        self.value = default
        self.options = options

    def check(self, v: Any) -> Any:
        if v not in self.options:
            raise ValueError(f"value {v!r} not in allowed options {self.options!r}")
        return v


class Params:
    """Attribute-style config node. Nested nodes are created on demand."""

    _RESERVED = ("_data", "_constraints")

    def __init__(self, **kwargs):
        object.__setattr__(self, "_data", {})
        object.__setattr__(self, "_constraints", {})
        for k, v in kwargs.items():
            setattr(self, k, v)

    def choice(self, *options) -> Any:
        """Declare a choice-constrained field: ``p.mode = p.choice('a', 'b')``.

        The first option is the default.
        """
        return Choice(options[0], tuple(options))

    def __setattr__(self, key: str, value: Any):
        if key in self._RESERVED:
            object.__setattr__(self, key, value)
            return
        self[key] = value

    def __getattr__(self, key: str) -> Any:
        # only called when normal lookup fails
        if key.startswith("__"):
            raise AttributeError(key)
        data = object.__getattribute__(self, "_data")
        if key not in data:
            # auto-vivify nested namespace (lets schemas write p.train.batch_size)
            data[key] = Params()
        return data[key]

    def __setitem__(self, key: str, value: Any):
        if "." in key:
            head, rest = key.split(".", 1)
            node = self._data.get(head)
            if not isinstance(node, Params):
                node = Params()
                self._data[head] = node
            node[rest] = value
            return
        if isinstance(value, Choice):
            self._constraints[key] = value
            self._data[key] = value.value
            return
        cons = self._constraints.get(key)
        if cons is not None:
            value = cons.check(value)
        self._data[key] = value

    def __getitem__(self, key: str) -> Any:
        if "." in key:
            head, rest = key.split(".", 1)
            return self._data[head][rest]
        return self._data[key]

    def get(self, key: str, default: Any = None) -> Any:
        try:
            v = self[key]
        except KeyError:
            return default
        if isinstance(v, Params) and len(v._data) == 0:
            return default
        return v

    def items(self):
        return self._data.items()

    def to_dict(self) -> dict:
        return {k: v.to_dict() if isinstance(v, Params) else v for k, v in self._data.items()}

    def from_args(self, argv: Optional[list] = None) -> "Params":
        """Apply ``--key=value`` / ``--key value`` / ``--flag`` overrides.

        Dotted keys address nested nodes: ``--train.batch_size=8``.
        """
        if argv is None:
            argv = sys.argv[1:]
        i = 0
        while i < len(argv):
            tok = argv[i]
            if not tok.startswith("--"):
                i += 1
                continue
            body = tok[2:]
            if "=" in body:
                k, v = body.split("=", 1)
            elif i + 1 < len(argv) and not argv[i + 1].startswith("--"):
                k, v = body, argv[i + 1]
                i += 1
            else:
                k, v = body, "true"
            self[k] = _parse_value(v)
            i += 1
        return self

    def __repr__(self):
        return f"{type(self).__name__}({self.to_dict()!r})"


class BaseParams(Params):
    """Params with a derived-config hook (``iparams``) run after overrides."""

    def iparams(self):
        """Compute derived config after CLI overrides (override in subclasses)."""

    def finalize(self, argv: Optional[list] = None) -> "BaseParams":
        self.from_args(argv)
        self.iparams()
        return self
