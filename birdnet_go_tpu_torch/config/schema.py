"""Config JSON-schema generation (reference: cmd/gen-schema →
config.schema.json for editor/IDE validation of config.yaml).

A copy of ``birdnet_go_tpu/config/schema.py`` for the port, over the port's
``Settings``; it imports nothing of the JAX package.
``tests/test_torch_recovery.py`` holds its output to the original's.
"""

from __future__ import annotations

import dataclasses
import json
import types
import typing
from typing import Any

from birdnet_go_tpu_torch.config.settings import Settings

_PRIMS = {int: "integer", float: "number", str: "string", bool: "boolean"}


def _type_schema(tp: Any) -> dict:
    origin = typing.get_origin(tp)
    if origin is None:
        if dataclasses.is_dataclass(tp):
            return _dataclass_schema(tp)
        if tp in _PRIMS:
            return {"type": _PRIMS[tp]}
        if tp is Any or tp is None or tp is type(None):
            return {}
        return {}
    if origin in (typing.Union, types.UnionType):
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        inner = _type_schema(args[0]) if args else {}
        return {"anyOf": [inner, {"type": "null"}]} \
            if type(None) in typing.get_args(tp) else inner
    if origin in (list, tuple):
        args = typing.get_args(tp)
        item = _type_schema(args[0]) if args else {}
        return {"type": "array", "items": item}
    if origin is dict:
        return {"type": "object"}
    return {}


def _dataclass_schema(cls) -> dict:
    hints = typing.get_type_hints(cls)
    props = {}
    for f in dataclasses.fields(cls):
        sch = _type_schema(hints.get(f.name, Any))
        if f.default is not dataclasses.MISSING \
                and not dataclasses.is_dataclass(f.default):
            sch = {**sch, "default": f.default}
        props[f.name] = sch
    return {"type": "object", "properties": props,
            "additionalProperties": False}


def generate_schema() -> dict:
    schema = _dataclass_schema(Settings)
    schema["$schema"] = "http://json-schema.org/draft-07/schema#"
    schema["title"] = "birdnet-tpu configuration"
    return schema


def schema_json(indent: int = 2) -> str:
    return json.dumps(generate_schema(), indent=indent, default=str)
