"""Config serialization — the port's copy of
`deeplearning4j_tpu/utils/serde.py`: dataclass trees <-> JSON through a
type registry.

A config object serializes as ``{"@type": tag, ...fields}`` and comes
back through the registry, enum fields coerced from their values by the
dataclass's type hints.  The port registers its config classes under the
JAX package's tags (the class names), with its field names, defaults and
enum values, so one ``configuration.json`` reads and writes in both
packages.

A tag listed in `UNPORTED` (one the JAX package has and the port does
not yet) raises `NotImplementedError` naming the ROADMAP item that
ports it; a tag neither package knows raises `KeyError`.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import typing
from typing import Any

_REGISTRY: dict[str, type] = {}

#: JAX package tags the port has no class for yet, and the ROADMAP item
#: each waits in (none: every tag of the JAX package's config modules is
#: registered)
UNPORTED: dict[str, str] = {}


def register(cls=None, *, name: str | None = None):
    """Class decorator registering a dataclass for config serde."""

    def wrap(c):
        tag = name or c.__name__
        existing = _REGISTRY.get(tag)
        if existing is not None and existing is not c:
            raise ValueError(f"duplicate serde tag {tag!r}: {existing} vs {c}")
        _REGISTRY[tag] = c
        return c

    return wrap(cls) if cls is not None else wrap


# the modules whose config classes register themselves on import
_CONFIG_MODULES = ("nn.conf.layers", "nn.conf.layers_nd", "nn.conf.attention",
                   "nn.conf.moe", "nn.conf.recurrent", "nn.conf.objdetect",
                   "nn.conf.pretrain", "nn.conf.graph_conf", "nn.conf.input_type",
                   "nn.conf.neural_net_configuration", "nn.updaters",
                   "nn.schedules", "autodiff.samediff")


def registered(tag: str) -> type:
    if tag not in _REGISTRY:
        # decoding must not depend on which modules the caller imported
        import importlib

        for mod in _CONFIG_MODULES:
            importlib.import_module(f"deeplearning4j_tpu_torch.{mod}")
    if tag not in _REGISTRY:
        if tag in UNPORTED:
            raise NotImplementedError(
                f"config type {tag!r} is not ported yet (ROADMAP "
                f"{UNPORTED[tag]})")
        raise KeyError(f"unknown config type tag {tag!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[tag]


def to_jsonable(obj: Any) -> Any:
    if isinstance(obj, enum.Enum):
        return obj.value
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        tag = type(obj).__name__
        if tag not in _REGISTRY:
            raise ValueError(f"{tag} is not @register-ed for serde; add the decorator")
        out = {"@type": tag}
        for f in dataclasses.fields(obj):
            out[f.name] = to_jsonable(getattr(obj, f.name))
        return out
    if isinstance(obj, (list, tuple)):
        return [to_jsonable(v) for v in obj]
    if isinstance(obj, dict):
        return {str(k): to_jsonable(v) for k, v in obj.items()}
    raise TypeError(f"cannot serialize {type(obj)} to config JSON")


def _coerce(value: Any, hint: Any) -> Any:
    """Best-effort coercion of a decoded JSON value to the annotated type."""
    if value is None:
        return None
    origin = typing.get_origin(hint)
    if origin is typing.Union:
        for arg in typing.get_args(hint):
            if arg is type(None):
                continue
            try:
                return _coerce(value, arg)
            except (TypeError, ValueError, KeyError):
                continue
        return value
    if isinstance(hint, type) and issubclass(hint, enum.Enum):
        return hint(value)
    if origin is tuple and isinstance(value, list):
        args = typing.get_args(hint)
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(_coerce(v, args[0]) for v in value)
        if args:
            return tuple(_coerce(v, a) for v, a in zip(value, args))
        return tuple(value)
    if origin is list and isinstance(value, list):
        (arg,) = typing.get_args(hint) or (Any,)
        return [_coerce(v, arg) for v in value]
    if origin is dict and isinstance(value, dict):
        _, vt = typing.get_args(hint) or (Any, Any)
        return {k: _coerce(v, vt) for k, v in value.items()}
    if isinstance(value, dict) and "@type" in value:
        return from_jsonable(value)
    if isinstance(value, list):
        return [from_jsonable(v) if isinstance(v, dict) and "@type" in v else v
                for v in value]
    if (isinstance(hint, type) and hint in (int, float, str, bool)
            and isinstance(value, (int, float, str, bool))):
        return hint(value)
    return value


def from_jsonable(data: Any) -> Any:
    if isinstance(data, dict) and "@type" in data:
        cls = registered(data["@type"])
        hints = typing.get_type_hints(cls)
        field_names = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in data.items():
            if k == "@type" or k not in field_names:
                continue
            decoded = from_jsonable(v) if isinstance(v, (dict, list)) else v
            kwargs[k] = _coerce(decoded, hints.get(k, Any))
        return cls(**kwargs)
    if isinstance(data, list):
        return [from_jsonable(v) for v in data]
    if isinstance(data, dict):
        return {k: from_jsonable(v) for k, v in data.items()}
    return data


def dumps(obj: Any, indent: int | None = 2) -> str:
    return json.dumps(to_jsonable(obj), indent=indent)


def loads(s: str) -> Any:
    return from_jsonable(json.loads(s))
