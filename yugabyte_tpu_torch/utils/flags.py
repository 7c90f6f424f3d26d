"""Flag registry with tags and runtime mutation.

Capability parity with gflags + yb flag tags (ref: src/yb/util/flag_tags.h;
runtime mutation via SetFlag RPC, src/yb/server/generic_service.cc). Flags are
process-global, typed, taggable, and hot-mutable; `get_flag` is cheap enough
for hot paths (dict lookup).
"""

from __future__ import annotations

import enum
import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional


class FlagTag(enum.Enum):
    STABLE = "stable"
    EVOLVING = "evolving"
    UNSAFE = "unsafe"
    RUNTIME = "runtime"  # mutable at runtime without restart
    SENSITIVE = "sensitive"
    ADVANCED = "advanced"
    HIDDEN = "hidden"
    TEST = "test"  # TEST_ flags: fault injection / test hooks


@dataclass
class _Flag:
    name: str
    default: Any
    help: str
    type: type
    tags: List[FlagTag]
    value: Any
    validator: Optional[Callable[[Any], bool]] = None


_REGISTRY: Dict[str, _Flag] = {}
_LOCK = threading.Lock()


def define_flag(name: str, default: Any, help: str = "", tags: List[FlagTag] = (),
                validator: Optional[Callable[[Any], bool]] = None) -> None:
    with _LOCK:
        if name in _REGISTRY:
            # Idempotent re-definition with identical default is fine (module reloads).
            if _REGISTRY[name].default != default:
                raise ValueError(f"flag {name} already defined with different default")
            return
        value = default
        env = os.environ.get(f"YBTPU_{name.upper()}")
        if env is not None:
            value = _parse(env, type(default))
            if validator and not validator(value):
                raise ValueError(
                    f"invalid env value for flag {name}: YBTPU_{name.upper()}={env!r}")
        _REGISTRY[name] = _Flag(name, default, help, type(default), list(tags), value, validator)


def _parse(text: str, typ: type) -> Any:
    if typ is bool:
        return text.lower() in ("1", "true", "yes", "on")
    return typ(text)


def get_flag(name: str) -> Any:
    return _REGISTRY[name].value


def set_flag(name: str, value: Any) -> None:
    with _LOCK:
        flag = _REGISTRY[name]
        if not isinstance(value, flag.type):
            value = _parse(str(value), flag.type)
        if flag.validator and not flag.validator(value):
            raise ValueError(f"invalid value for flag {name}: {value!r}")
        flag.value = value


def all_flags() -> Dict[str, Any]:
    return {name: f.value for name, f in _REGISTRY.items()}


def reset_flag(name: str) -> None:
    with _LOCK:
        _REGISTRY[name].value = _REGISTRY[name].default
