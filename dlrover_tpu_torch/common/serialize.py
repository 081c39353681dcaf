"""Typed message serialization for the control plane: the port of
``dlrover_tpu/common/serialize.py``.

Every message type registers itself in a class registry and travels as
``{"_t": <registered name>, ...fields}``, as in the JAX module. The JAX
module packs that with msgpack; the port encodes it as JSON (UTF-8), since
the machines it runs on need not have msgpack. JSON has neither bytes nor
non-string keys, so two more reserved tags carry them: bytes go as
``{"_t": "__bytes__", "b64": ...}`` and a plain dict whose keys are not all
strings (or that holds ``_t`` itself) goes as
``{"_t": "__rawdict__", "kv": [[k, v], ...]}``. Decoded values equal the
JAX round trip's: tuples come back as lists, int keys as ints.

The two packages' wires therefore differ, and their masters and clients
do not talk to each other.
"""

import base64
import dataclasses
import json
from typing import Any, Dict, Type

_REGISTRY: Dict[str, Type] = {}
_TYPE_KEY = "_t"
_RAW_DICT = "__rawdict__"  # reserved: plain dict with non-str keys or a _t key
_BYTES = "__bytes__"  # reserved: bytes as base64


def register_message(cls):
    """Class decorator: make a dataclass wire-serializable."""
    name = cls.__name__
    if name in (_RAW_DICT, _BYTES):
        raise ValueError(f"{name} is reserved")
    if name in _REGISTRY and _REGISTRY[name] is not cls:
        raise ValueError(f"duplicate message type {name}")
    _REGISTRY[name] = cls
    return cls


def _encode(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        name = type(obj).__name__
        if name not in _REGISTRY:
            raise TypeError(f"unregistered message type {name}")
        out = {_TYPE_KEY: name}
        for f in dataclasses.fields(obj):
            out[f.name] = _encode(getattr(obj, f.name))
        return out
    if isinstance(obj, dict):
        for k in obj:
            if not isinstance(k, (str, int, float, bool, bytes)):
                raise TypeError(f"unserializable dict key of type {type(k)!r}")
        if _TYPE_KEY in obj or not all(isinstance(k, str) for k in obj):
            return {_TYPE_KEY: _RAW_DICT, "kv": [[_encode(k), _encode(v)] for k, v in obj.items()]}
        return {k: _encode(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_encode(v) for v in obj]
    if isinstance(obj, bytes):
        return {_TYPE_KEY: _BYTES, "b64": base64.b64encode(obj).decode("ascii")}
    if isinstance(obj, (str, int, float, bool, type(None))):
        return obj
    raise TypeError(f"unserializable value of type {type(obj)!r}")


def _decode(obj: Any) -> Any:
    if isinstance(obj, dict):
        if _TYPE_KEY in obj:
            name = obj[_TYPE_KEY]
            if name == _BYTES:
                return base64.b64decode(obj["b64"])
            if name == _RAW_DICT:
                return {_decode(k): _decode(v) for k, v in obj["kv"]}
            cls = _REGISTRY.get(name)
            if cls is None:
                # the registry fills as modules import: pull in the
                # standard schema before giving up
                from . import comm  # noqa: F401  (registers its dataclasses)

                cls = _REGISTRY.get(name)
            if cls is None:
                raise TypeError(f"unknown message type {name}")
            return cls(**{k: _decode(v) for k, v in obj.items() if k != _TYPE_KEY})
        return {k: _decode(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode(v) for v in obj]
    return obj


def dumps(message: Any) -> bytes:
    return json.dumps(_encode(message), separators=(",", ":")).encode()


def loads(data: bytes) -> Any:
    if not data:
        return None
    return _decode(json.loads(data))
