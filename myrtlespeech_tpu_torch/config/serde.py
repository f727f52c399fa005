"""Config (de)serialisation: TaskConfig <-> plain dicts / JSON.

The port's copy of ``myrtlespeech_tpu/config/serde.py`` over the port's
schema: a JSON file saved by either package loads in the other, and a
``.py`` config must build the port's ``TaskConfig`` (the port's own copies
live under ``myrtlespeech_tpu_torch/configs/``).

The reference parses protobuf text-format ``.config`` files
(``run/run.py`` via ``text_format.Merge``).  Here configs are dataclasses;
this module gives them a stable JSON wire format.  Union ("oneof") fields
are encoded with a ``"kind"`` tag naming the dataclass; enums by value.

A config file can be either:
- ``*.json`` — this wire format, or
- ``*.py``  — a Python file defining ``task_config`` (full expressive
  power of the schema; the idiomatic "declarative builder" form).
"""

from __future__ import annotations

import dataclasses
import enum
import importlib.util
import json
import typing
from typing import Any, Dict, Type

from myrtlespeech_tpu_torch.config import schema as S

# All dataclass types that may appear in unions, by class name.
_TYPES: Dict[str, Type] = {
    name: obj for name, obj in vars(S).items()
    if dataclasses.is_dataclass(obj)
}
_ENUMS: Dict[str, Type] = {
    name: obj for name, obj in vars(S).items()
    if isinstance(obj, type) and issubclass(obj, enum.Enum)
}


def to_dict(obj: Any) -> Any:
    """Dataclass tree -> json-able dict with 'kind' tags."""
    if dataclasses.is_dataclass(obj):
        out = {"kind": type(obj).__name__}
        for f in dataclasses.fields(obj):
            out[f.name] = to_dict(getattr(obj, f.name))
        return out
    if isinstance(obj, enum.Enum):
        return {"enum": type(obj).__name__, "value": obj.value}
    if isinstance(obj, tuple):
        return [to_dict(x) for x in obj]
    return obj


def from_dict(d: Any) -> Any:
    """Inverse of :func:`to_dict`."""
    if isinstance(d, dict) and "kind" in d:
        cls = _TYPES[d["kind"]]
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name in d:
                v = from_dict(d[f.name])
                # dataclass tuple fields arrive as lists
                origin = typing.get_origin(f.type) if not isinstance(
                    f.type, str) else None
                if isinstance(v, list):
                    v = tuple(v)
                kwargs[f.name] = v
        return cls(**kwargs)
    if isinstance(d, dict) and "enum" in d:
        return _ENUMS[d["enum"]](d["value"])
    if isinstance(d, list):
        return tuple(from_dict(x) for x in d)
    return d


def save_json(cfg: S.TaskConfig, path: str) -> None:
    with open(path, "w") as f:
        json.dump(to_dict(cfg), f, indent=2)


def load(path: str) -> S.TaskConfig:
    """Load a TaskConfig from ``.json`` or ``.py`` (defines task_config)."""
    if path.endswith(".json"):
        with open(path) as f:
            cfg = from_dict(json.load(f))
    elif path.endswith(".py"):
        spec = importlib.util.spec_from_file_location("_user_config", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)  # type: ignore[union-attr]
        cfg = getattr(mod, "task_config")
    else:
        raise ValueError(f"config must be .json or .py, got {path}")
    if not isinstance(cfg, S.TaskConfig):
        raise TypeError(f"{path} did not produce a TaskConfig")
    return cfg
