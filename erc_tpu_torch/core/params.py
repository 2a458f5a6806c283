"""Schema-in-code configuration with constraints and CLI overrides.

Port of ``erc_tpu.core.params``: attribute-style schema with defaults
declared in ``__init__``, ``choice()`` and ``arange()`` constraints
enforced on every assignment, dotted-key CLI overrides
(``--train.batch_size=8``), ``--config=<file>``: a yaml or json file
loaded before the other flags, so that the flags win (yaml read with
``yaml`` where it is installed, else the file is read as json), json and
yaml dumps, and the JAX package's content hashes (``hash``, and
``resume_hash`` over the knobs that define a run's identity), byte for
byte: the same config gives the same hash in both packages.
"""

from __future__ import annotations

import hashlib
import json
import sys
from typing import Any, Iterator, Optional


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


class Arange:
    """A numeric value constrained to [lo, hi]."""

    __slots__ = ("value", "lo", "hi")

    def __init__(self, default: float, lo: float, hi: float):
        self.lo, self.hi = lo, hi
        self.value = self.check(default)

    def check(self, v: float) -> float:
        if not (self.lo <= v <= self.hi):
            raise ValueError(f"value {v!r} outside range [{self.lo}, {self.hi}]")
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

    def arange(self, default, lo, hi) -> Any:
        """Declare a range-constrained field: ``p.rate = p.arange(0.5, 0, 1)``."""
        return Arange(default, lo, hi)

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
        if isinstance(value, (Choice, Arange)):
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

    def keys(self) -> Iterator[str]:
        return iter(self._data.keys())

    def items(self):
        return self._data.items()

    def to_dict(self) -> dict:
        return {k: v.to_dict() if isinstance(v, Params) else v for k, v in self._data.items()}

    def update(self, other) -> "Params":
        """Merge a dict (or Params) in: nested dicts into existing nodes."""
        if isinstance(other, Params):
            other = other.to_dict()
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(self._data.get(k), Params):
                self._data[k].update(v)
            else:
                self[k] = v
        return self

    def to_json(self, path: Optional[str] = None, indent: int = 2) -> str:
        s = json.dumps(self.to_dict(), indent=indent, default=str, sort_keys=True)
        if path is not None:
            with open(path, "w") as f:
                f.write(s)
        return s

    def to_yaml(self, path: Optional[str] = None) -> str:
        """The config as yaml, or as json where ``yaml`` is not installed."""
        try:
            import yaml

            s = yaml.safe_dump(self.to_dict(), sort_keys=True)
        except ImportError:
            s = self.to_json(indent=2)
        if path is not None:
            with open(path, "w") as f:
                f.write(s)
        return s

    def from_dict(self, d: dict) -> "Params":
        return self.update(d)

    def from_json_file(self, path: str) -> "Params":
        with open(path) as f:
            return self.update(json.load(f))

    def from_yaml_file(self, path: str) -> "Params":
        """A yaml file, or the file as json where ``yaml`` is not installed."""
        try:
            import yaml
        except ImportError:
            return self.from_json_file(path)
        with open(path) as f:
            return self.update(yaml.safe_load(f))

    def hash(self) -> str:
        """Stable content hash: md5 of the sorted json, 16 hex digits."""
        return _md5(self.to_dict())

    # run-control knobs that a preempted job legitimately changes when it is
    # relaunched (--resume with a longer --epoch, other cadences, another
    # card or save directory); everything else (model, optimizer, data)
    # defines resume identity.  The JAX package's set, with the port's own
    # run-control knob save_dir.
    _VOLATILE_KEYS = frozenset({
        "epoch", "resume", "eval_per_epoch", "eval_first", "eval_val",
        "select_on", "checkpoint_per_epoch", "checkpoint_per_step",
        "keypoint_per_epoch", "batch_count", "heartbeat", "profile_steps",
        "log_every", "prefetch", "steps_per_call", "eval_steps_per_call",
        "device", "pretrain_path",
        # every process of one logical run differs in process_id, and a
        # relaunch may move the coordinator
        "coordinator", "num_processes", "process_id",
        "save_dir",
    })

    def resume_hash(self) -> str:
        """Identity hash for checkpoint-resume compatibility: the config
        minus the run-control knobs (``AutoResume`` finds sibling runs by
        it)."""
        return _md5({k: v for k, v in self.to_dict().items() if k not in self._VOLATILE_KEYS})

    def from_args(self, argv: Optional[list] = None) -> "Params":
        """Apply ``--key=value`` / ``--key value`` / ``--flag`` overrides.

        Dotted keys address nested nodes: ``--train.batch_size=8``.  Every
        ``--config=<file>`` is loaded first (``from_yaml_file``), so that
        the other flags win over the file.
        """
        if argv is None:
            argv = sys.argv[1:]
        pairs = []
        i = 0
        while i < len(argv):
            tok = argv[i]
            if not tok.startswith("--"):
                i += 1
                continue
            body = tok[2:]
            if "=" in body:
                pairs.append(tuple(body.split("=", 1)))
            elif i + 1 < len(argv) and not argv[i + 1].startswith("--"):
                pairs.append((body, argv[i + 1]))
                i += 1
            else:
                pairs.append((body, "true"))
            i += 1
        for k, v in pairs:
            if k == "config":
                self.from_yaml_file(v)
        for k, v in pairs:
            if k != "config":
                self[k] = _parse_value(v)
        return self

    def __repr__(self):
        return f"{type(self).__name__}({self.to_dict()!r})"

    def __eq__(self, other):
        return isinstance(other, Params) and self.to_dict() == other.to_dict()


def _md5(d: dict) -> str:
    return hashlib.md5(json.dumps(d, sort_keys=True, default=str).encode()).hexdigest()[:16]


class BaseParams(Params):
    """Params with a derived-config hook (``iparams``) run after overrides."""

    def iparams(self):
        """Compute derived config after CLI overrides (override in subclasses)."""

    def finalize(self, argv: Optional[list] = None) -> "BaseParams":
        self.from_args(argv)
        self.iparams()
        return self
