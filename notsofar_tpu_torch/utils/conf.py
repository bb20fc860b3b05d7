"""Typed YAML -> dataclass configuration loader.

Copy of notsofar_tpu/utils/conf.py (the port imports nothing from the JAX
package): a YAML mapping is merged into a dataclass schema recursively;
unknown keys and incompatible value types are rejected. ``yaml`` is
imported only by the functions that read YAML.
"""
from __future__ import annotations

import copy
import dataclasses
import math
import typing
from pathlib import Path
from typing import Any, Dict, Type, TypeVar, Union

ConfT = TypeVar("ConfT")


class ConfigError(ValueError):
    pass


def _is_optional(tp) -> bool:
    return typing.get_origin(tp) is Union and type(None) in typing.get_args(tp)


def _unwrap_optional(tp):
    args = [a for a in typing.get_args(tp) if a is not type(None)]
    if len(args) == 1:
        return args[0]
    return tp


def _coerce(value: Any, tp, path: str):
    """Coerce a YAML value into the annotated type `tp`, validating as we go."""
    if value is None:
        if _is_optional(tp) or tp is Any:
            return None
        raise ConfigError(f"{path}: null not allowed for type {tp}")

    if _is_optional(tp):
        tp = _unwrap_optional(tp)

    origin = typing.get_origin(tp)

    if dataclasses.is_dataclass(tp):
        if not isinstance(value, dict):
            raise ConfigError(f"{path}: expected mapping for {tp.__name__}, got {type(value).__name__}")
        return _merge_into_dataclass(tp(), value, path)

    if tp is Any:
        return value
    if tp is float:
        if isinstance(value, bool):
            raise ConfigError(f"{path}: expected float, got bool")
        if isinstance(value, (int, float)):
            return float(value)
        if isinstance(value, str):
            # YAML 1.1 loaders leave '-inf', '1e-4' etc. as strings sometimes
            try:
                return float(value)
            except ValueError:
                pass
        raise ConfigError(f"{path}: expected float, got {value!r}")
    if tp is int:
        if isinstance(value, bool):
            raise ConfigError(f"{path}: expected int, got bool")
        if isinstance(value, int):
            return value
        if isinstance(value, float) and value.is_integer():
            return int(value)
        raise ConfigError(f"{path}: expected int, got {value!r}")
    if tp is bool:
        if isinstance(value, bool):
            return value
        raise ConfigError(f"{path}: expected bool, got {value!r}")
    if tp is str:
        if isinstance(value, str):
            return value
        raise ConfigError(f"{path}: expected str, got {value!r}")

    if origin in (list, typing.List):
        (elem_tp,) = typing.get_args(tp) or (Any,)
        if not isinstance(value, (list, tuple)):
            raise ConfigError(f"{path}: expected list, got {value!r}")
        return [_coerce(v, elem_tp, f"{path}[{i}]") for i, v in enumerate(value)]

    if origin in (tuple, typing.Tuple):
        args = typing.get_args(tp)
        if not isinstance(value, (list, tuple)):
            raise ConfigError(f"{path}: expected tuple, got {value!r}")
        if args and args[-1] is Ellipsis:
            return tuple(_coerce(v, args[0], f"{path}[{i}]") for i, v in enumerate(value))
        if args and len(args) == len(value):
            return tuple(_coerce(v, a, f"{path}[{i}]") for i, (v, a) in enumerate(zip(value, args)))
        # untyped Tuple (like the reference's `(N, 'epochs')` frequency pairs)
        return tuple(value)

    if origin in (dict, typing.Dict):
        if not isinstance(value, dict):
            raise ConfigError(f"{path}: expected mapping, got {value!r}")
        args = typing.get_args(tp)
        v_tp = args[1] if len(args) == 2 else Any
        return {k: _coerce(v, v_tp, f"{path}.{k}") for k, v in value.items()}

    # Fallback: accept as-is (e.g. unannotated fields)
    return value


def _merge_into_dataclass(obj: ConfT, updates: Dict[str, Any], path: str = "") -> ConfT:
    hints = typing.get_type_hints(type(obj))
    fields = {f.name: f for f in dataclasses.fields(obj)}
    for key, value in updates.items():
        kpath = f"{path}.{key}" if path else key
        if key not in fields:
            raise ConfigError(f"unknown config key: {kpath} (for {type(obj).__name__})")
        tp = hints.get(key, Any)
        inner = tp
        if _is_optional(inner):
            inner = _unwrap_optional(inner)
        if dataclasses.is_dataclass(inner) and isinstance(value, dict):
            # merge into the existing (possibly default-constructed) sub-config
            current = getattr(obj, key)
            if current is None:
                current = inner()
            setattr(obj, key, _merge_into_dataclass(current, value, kpath))
        else:
            setattr(obj, key, _coerce(value, tp, kpath))
    return obj


def load_yaml_to_dataclass(yaml_path: Union[str, Path], conf_type: Type[ConfT]) -> ConfT:
    """Load a YAML file and merge it into a default-constructed `conf_type`.

    Missing keys keep their dataclass defaults; unknown keys raise.
    """
    import yaml
    with open(yaml_path, "r") as f:
        raw = yaml.safe_load(f) or {}
    if not isinstance(raw, dict):
        raise ConfigError(f"{yaml_path}: top-level YAML must be a mapping")
    # YAML 1.1 '-inf'/'inf'/'nan' parse as strings with safe_load in some
    # libyaml builds; floats are handled in _coerce. '.inf' parses natively.
    return _merge_into_dataclass(conf_type(), raw)


def update_dataclass(dataclass_obj: ConfT, updates: Dict[str, Any]) -> ConfT:
    """Update a dataclass config using dot-notation keys."""
    obj = copy.deepcopy(dataclass_obj)
    for dotted, value in updates.items():
        parts = dotted.split(".")
        target = obj
        for p in parts[:-1]:
            target = getattr(target, p)
        leaf = parts[-1]
        if not hasattr(target, leaf):
            raise ConfigError(f"unknown config key: {dotted}")
        hints = typing.get_type_hints(type(target))
        setattr(target, leaf, _coerce(value, hints.get(leaf, Any), dotted))
    return obj


def dataclass_to_dict(obj) -> Dict[str, Any]:
    """Recursively convert a dataclass config to plain dict (for YAML dump)."""
    d = dataclasses.asdict(obj)

    def clean(v):
        if isinstance(v, dict):
            return {k: clean(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [clean(x) for x in v]
        if isinstance(v, float) and math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        return v

    return clean(d)
