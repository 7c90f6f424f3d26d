"""JSON with a tagged escape for raw bytes.

Counterpart of yugabyte_tpu/utils/jsonutil.py, with the imports renamed.

Catalog and tablet metadata carry raw partition-bound / key bytes; the
reference persists protobuf superblocks (no such problem), here JSON sidecars
need `{"__bytes__": hex}` tagging.
"""

from __future__ import annotations

import json


def jsonable(obj):
    if isinstance(obj, bytes):
        return {"__bytes__": obj.hex()}
    if isinstance(obj, dict):
        return {k: jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonable(v) for v in obj]
    return obj


def unjsonable(obj):
    if isinstance(obj, dict):
        if set(obj) == {"__bytes__"}:
            return bytes.fromhex(obj["__bytes__"])
        return {k: unjsonable(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [unjsonable(v) for v in obj]
    return obj


def dumps(obj, **kw) -> str:
    return json.dumps(jsonable(obj), **kw)


def loads(s: str):
    return unjsonable(json.loads(s))


def write_atomic(path: str, obj) -> None:
    """Write-fsync-rename of a JSON document (superblocks, consensus
    metadata sidecars)."""
    import os
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(dumps(obj))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def read_file(path: str):
    with open(path) as f:
        return loads(f.read())
