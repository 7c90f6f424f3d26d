"""JSONB document support shared by the YCQL and YSQL layers.

Counterpart of yugabyte_tpu/common/jsonb.py, with the imports renamed.

The reference serializes jsonb to a binary sorted-key format
(ref: src/yb/common/jsonb.h:33-66) so documents compare deterministically
and keys binary-search. Our storage form keeps the same properties with
canonical compact JSON text: object keys sorted, no whitespace — equal
documents always store byte-identical. Path navigation (-> / ->>)
mirrors common/jsonb.cc ApplyJsonbOperators: missing keys, out-of-range
indexes and scalar mismatches yield NULL, never an error.
"""

from __future__ import annotations

import json
from typing import Optional, Sequence


def canonicalize(v) -> str:
    """Validate + canonicalize a jsonb input value to storage text.

    Accepts json text (the normal literal path) or an already-materialized
    python value (bound params arriving through a wire codec).
    Raises ValueError on malformed json / unsupported input type.
    """
    if isinstance(v, (dict, list, int, float, bool)) or v is None:
        return json.dumps(v, sort_keys=True, separators=(",", ":"),
                          allow_nan=False)
    if not isinstance(v, str):
        raise ValueError(
            f"jsonb value must be a json text literal, "
            f"got {type(v).__name__}")
    # spec-strict: NaN/Infinity are not JSON (PG rejects them with 22P02)
    # and NaN would break the canonical-equality guarantee (NaN != NaN)
    doc = json.loads(v, parse_constant=_reject_constant)
    return json.dumps(doc, sort_keys=True, separators=(",", ":"),
                      allow_nan=False)


def _reject_constant(name: str):
    raise ValueError(f"{name} is not valid JSON")


def navigate(stored: Optional[str], path: Sequence, as_text: bool):
    """Apply a -> / ->> chain over stored canonical json text.

    path holds object keys (str) and array indexes (int); as_text marks a
    trailing ->> (unquote strings / stringify scalars). Returns None for
    any miss (PG + reference jsonb operator semantics)."""
    if stored is None:
        return None
    try:
        doc = json.loads(stored)
    except ValueError:
        return None
    for step in path:
        if isinstance(step, int) and not isinstance(step, bool):
            if not isinstance(doc, list) or not (-len(doc) <= step
                                                 < len(doc)):
                return None
            doc = doc[step]
        else:
            if not isinstance(doc, dict) or step not in doc:
                return None
            doc = doc[step]
    if as_text:
        if doc is None:
            return None
        if isinstance(doc, bool):
            return "true" if doc else "false"
        if isinstance(doc, (dict, list)):
            return json.dumps(doc, sort_keys=True, separators=(",", ":"))
        return str(doc)
    return json.dumps(doc, sort_keys=True, separators=(",", ":"))
