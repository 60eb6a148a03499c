"""Dataclass → JSON-schema generation for the OpenAPI document.

The port's copy of ``panoptikon_tpu/utils/schema_gen.py``, held to it unit for unit by
``tests/test_torch_host_copies.py``.

The reference derives its OpenAPI component schemas from the Rust types
via utoipa (openapi.rs); here the PQL dataclasses ARE the wire types, so
the schemas derive from their annotations: Optional/list/dict/unions,
nested dataclasses as ``$ref`` components, private fields (leading ``_``)
omitted.
"""

from __future__ import annotations

import dataclasses
import types
import typing
from typing import Any, Optional, Union

_PRIMITIVES = {
    str: {"type": "string"},
    int: {"type": "integer"},
    float: {"type": "number"},
    bool: {"type": "boolean"},
    Any: {},
}


def _resolve(tp, components: dict) -> dict:
    origin = typing.get_origin(tp)
    args = typing.get_args(tp)
    if tp in _PRIMITIVES:
        return dict(_PRIMITIVES[tp])
    if origin in (Union, types.UnionType):
        non_none = [a for a in args if a is not type(None)]
        schemas = [_resolve(a, components) for a in non_none]
        out = schemas[0] if len(schemas) == 1 else {"anyOf": schemas}
        if type(None) in args:
            out = dict(out)
            out["nullable"] = True
        return out
    if origin in (list, tuple):
        item = _resolve(args[0], components) if args else {}
        return {"type": "array", "items": item}
    if origin is dict:
        val = _resolve(args[1], components) if len(args) == 2 else {}
        return {"type": "object", "additionalProperties": val}
    if origin is typing.Literal:
        return {"enum": list(args)}
    if dataclasses.is_dataclass(tp):
        name = tp.__name__
        if name not in components:
            components[name] = None  # cycle guard
            components[name] = dataclass_schema(tp, components)
        return {"$ref": f"#/components/schemas/{name}"}
    if isinstance(tp, str):
        # Forward reference we can't resolve here; keep it loose.
        return {}
    return {}


def dataclass_schema(cls, components: dict) -> dict:
    """One dataclass → an object schema; nested dataclasses land in
    ``components`` keyed by class name."""
    hints = typing.get_type_hints(cls)
    props = {}
    required = []
    for f in dataclasses.fields(cls):
        if f.name.startswith("_"):
            continue
        schema = _resolve(hints.get(f.name, Any), components)
        if f.metadata.get("doc"):
            schema["description"] = f.metadata["doc"]
        props[f.name] = schema
        if (
            f.default is dataclasses.MISSING
            and f.default_factory is dataclasses.MISSING
        ):
            required.append(f.name)
    out: dict = {"type": "object", "properties": props}
    if required:
        out["required"] = required
    if cls.__doc__:
        out["description"] = cls.__doc__.strip().split("\n")[0]
    return out


def collect_schemas(classes) -> dict:
    """Schemas for ``classes`` and everything they reference."""
    components: dict = {}
    for cls in classes:
        _resolve(cls, components)
    return components
