"""Env: the storage-file abstraction (plaintext only in this package).

Counterpart of yugabyte_tpu/utils/env.py's plaintext `Env` (ref:
src/yb/util/env.h). The storage engine's byte paths (SST data and base
files) go through the process Env. The encrypted Env and the
fault-injection wrapper are not ported yet: the compaction job raises
NotImplementedError when `get_env().encrypted` is set.
"""

from __future__ import annotations

import os


class Env:
    """Plaintext passthru (the default)."""

    encrypted = False

    # ---------------------------------------------------------- whole file
    def read_file(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def write_file(self, path: str, data: bytes) -> None:
        with open(path, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())

    # ------------------------------------------------------- random access
    def open_random(self, path: str) -> "RandomAccessFile":
        return RandomAccessFile(path)

    # -------------------------------------------------------------- append
    def open_append(self, path: str) -> "AppendFile":
        return AppendFile(path)


class RandomAccessFile:
    def __init__(self, path: str):
        self._fd = os.open(path, os.O_RDONLY)

    def pread(self, size: int, offset: int) -> bytes:
        return os.pread(self._fd, size, offset)

    def size(self) -> int:
        return os.fstat(self._fd).st_size

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1


class AppendFile:
    def __init__(self, path: str):
        self._f = open(path, "ab")

    @property
    def offset(self) -> int:
        return self._f.tell()

    def append(self, data: bytes) -> None:
        self._f.write(data)

    def flush(self, fsync: bool = True) -> None:
        self._f.flush()
        if fsync:
            os.fsync(self._f.fileno())

    def close(self) -> None:
        self._f.close()


# ------------------------------------------------------------ process env
_env: Env = Env()


def get_env() -> Env:
    return _env


def set_env(env: Env) -> None:
    global _env
    _env = env
