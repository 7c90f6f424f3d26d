"""Env: the storage-file abstraction, with transparent encryption at rest
and a fault-injection wrapper for crash/disk-error testing.

Counterpart of yugabyte_tpu/utils/env.py (ref: src/yb/util/env.h;
src/yb/encryption/encrypted_file.cc — every data file gets a random DATA
KEY, wrapped by the cluster-wide UNIVERSE KEY and stored in a file header;
AES-CTR keyed per file allows random-access reads). The storage engine's
byte paths (SST data/base files, WAL segments, MANIFEST edits) go through
the process Env; the plaintext Env is a thin passthru and the encrypted
Env wraps the same operations. The file format is the JAX package's, so
each package reads the other's encrypted files given the same keys.

AES comes from the `cryptography` package, imported only when a cipher is
made: a process that never turns encryption on does not need it.

FaultInjectionEnv (ref: rocksdb/db/fault_injection_test.cc
FaultInjectionTestEnv) stacks over either and injects pread errors,
failed/short (torn) appends, ENOSPC, and silently-dropped fsyncs whose
unsynced bytes are lost on simulate_crash() — the substrate every
background-error-containment test drives.

Header layout of an encrypted file:
    b"YBENCv1\\0" | u16 key_id_len | key_id | 16B nonce | 32B wrapped key
Body bytes at logical offset L live at physical offset header_len + L,
encrypted with AES-CTR(data_key, nonce) at counter position L — so pread
at any offset decrypts exactly the requested range.
"""

from __future__ import annotations

import os
import secrets
import struct
import threading
from typing import Dict, List, Optional, Tuple

_MAGIC = b"YBENCv1\x00"


def _ctr_cipher(key: bytes, nonce: bytes, byte_offset: int = 0):
    from cryptography.hazmat.primitives.ciphers import (
        Cipher, algorithms, modes)
    # advance the 128-bit counter to the block containing byte_offset
    blocks = byte_offset // 16
    ctr = (int.from_bytes(nonce, "big") + blocks) % (1 << 128)
    c = Cipher(algorithms.AES(key),
               modes.CTR(ctr.to_bytes(16, "big"))).encryptor()
    skip = byte_offset % 16
    if skip:
        c.update(b"\x00" * skip)  # discard partial leading block
    return c


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


# ---------------------------------------------------------------- encrypted
class UniverseKeys:
    """In-process registry of universe keys (master-distributed;
    ref ent/src/yb/master/universe_key_registry_service.cc)."""

    def __init__(self):
        self._keys: Dict[str, bytes] = {}
        self._latest: Optional[str] = None
        self._lock = threading.Lock()

    def add(self, key_id: str, key: bytes, make_latest: bool = True) -> None:
        assert len(key) == 32, "universe keys are AES-256"
        with self._lock:
            self._keys[key_id] = key
            if make_latest or self._latest is None:
                self._latest = key_id

    def get(self, key_id: str) -> bytes:
        with self._lock:
            key = self._keys.get(key_id)
        if key is None:
            raise KeyError(f"universe key {key_id!r} not available")
        return key

    def latest(self) -> Tuple[str, bytes]:
        with self._lock:
            if self._latest is None:
                raise KeyError("no universe key configured")
            return self._latest, self._keys[self._latest]


class EncryptedEnv(Env):
    encrypted = True

    def __init__(self, keys: UniverseKeys):
        self.keys = keys

    # ------------------------------------------------------------- header
    def _new_header(self) -> Tuple[bytes, bytes]:
        key_id, ukey = self.keys.latest()
        nonce = secrets.token_bytes(16)
        data_key = secrets.token_bytes(32)
        wrapped = _ctr_cipher(ukey, nonce).update(data_key)
        kid = key_id.encode()
        header = (_MAGIC + struct.pack("<H", len(kid)) + kid + nonce
                  + wrapped)
        return header, (data_key, nonce)

    def _read_header(self, blob: bytes) -> Tuple[int, bytes, bytes]:
        """-> (header_len, data_key, nonce). A short blob (torn/truncated
        header after a crash mid-create) fails loudly here instead of
        keying the cipher with garbage bytes."""
        if blob[: len(_MAGIC)] != _MAGIC:
            raise ValueError("not an encrypted file")
        if len(blob) < len(_MAGIC) + 2:
            raise ValueError("truncated encrypted-file header "
                             f"({len(blob)} bytes)")
        (kid_len,) = struct.unpack_from("<H", blob, len(_MAGIC))
        p = len(_MAGIC) + 2
        if len(blob) < p + kid_len + 48:
            raise ValueError("truncated encrypted-file header "
                             f"({len(blob)} bytes, need {p + kid_len + 48})")
        key_id = blob[p: p + kid_len].decode()
        p += kid_len
        nonce = blob[p: p + 16]
        wrapped = blob[p + 16: p + 48]
        ukey = self.keys.get(key_id)
        data_key = _ctr_cipher(ukey, nonce).update(wrapped)
        return p + 48, data_key, nonce

    # ---------------------------------------------------------- whole file
    def read_file(self, path: str) -> bytes:
        blob = super().read_file(path)
        if blob[: len(_MAGIC)] != _MAGIC:
            return blob  # legacy plaintext file (pre-encryption enable)
        hlen, data_key, nonce = self._read_header(blob)
        return _ctr_cipher(data_key, nonce).update(blob[hlen:])

    def write_file(self, path: str, data: bytes) -> None:
        header, (data_key, nonce) = self._new_header()
        super().write_file(
            path, header + _ctr_cipher(data_key, nonce).update(data))

    # ------------------------------------------------------- random access
    def open_random(self, path: str):
        raw = RandomAccessFile(path)
        head = raw.pread(len(_MAGIC), 0)
        if head != _MAGIC:
            return raw  # legacy plaintext file
        raw.close()
        return EncryptedRandomAccessFile(self, path)

    def open_append(self, path: str):
        if os.path.exists(path) and os.path.getsize(path) > 0:
            with open(path, "rb") as f:
                if f.read(len(_MAGIC)) != _MAGIC:
                    return AppendFile(path)  # continue a legacy file
        return EncryptedAppendFile(self, path)


class EncryptedRandomAccessFile:
    def __init__(self, env: EncryptedEnv, path: str):
        self._raw = RandomAccessFile(path)
        try:
            head = self._raw.pread(4096, 0)
            self._hlen, self._key, self._nonce = env._read_header(head)
        except BaseException:
            self._raw.close()  # no fd leak on a torn header
            raise

    def pread(self, size: int, offset: int) -> bytes:
        enc = self._raw.pread(size, self._hlen + offset)
        return _ctr_cipher(self._key, self._nonce, offset).update(enc)

    def size(self) -> int:
        return self._raw.size() - self._hlen

    def close(self) -> None:
        self._raw.close()


class EncryptedAppendFile:
    def __init__(self, env: EncryptedEnv, path: str):
        exists = os.path.exists(path) and os.path.getsize(path) > 0
        if exists:
            with open(path, "rb") as f:
                head = f.read(4096)
            self._hlen, key, nonce = env._read_header(head)
            self._f = open(path, "ab")
            start = self._f.tell() - self._hlen
        else:
            header, (key, nonce) = env._new_header()
            self._hlen = len(header)
            self._f = open(path, "wb")
            self._f.write(header)
            start = 0
        self._key, self._nonce = key, nonce
        self._cipher = _ctr_cipher(key, nonce, start)

    @property
    def offset(self) -> int:
        return self._f.tell() - self._hlen

    def append(self, data: bytes) -> None:
        self._f.write(self._cipher.update(data))

    def flush(self, fsync: bool = True) -> None:
        self._f.flush()
        if fsync:
            os.fsync(self._f.fileno())

    def close(self) -> None:
        self._f.close()


def looks_encrypted(path: str) -> bool:
    """True if the file carries the encrypted-file header."""
    try:
        with open(path, "rb") as f:
            return f.read(len(_MAGIC)) == _MAGIC
    except OSError:
        return False


# ----------------------------------------------------------- fault injection
class FaultError(OSError):
    """An injected disk fault. Subclasses OSError so every layer treats it
    exactly like a real I/O error; tests can still single it out."""


class FaultInjectionEnv(Env):
    """Env wrapper that injects disk faults (ref:
    rocksdb/db/fault_injection_test.cc FaultInjectionTestEnv). Stacks over
    any base Env — including EncryptedEnv, so faults hit the ciphertext
    byte stream exactly like a failing disk would.

    Fault kinds (armed via set_fault(kind, path_filter, count)):
      - "read":         pread / read_file raises FaultError
      - "append":       append raises before writing anything
      - "append_short": append writes a PREFIX then raises (a torn write)
      - "enospc":       append / write_file raise OSError(ENOSPC)
    path_filter is a substring match on the path ("" = every file); count
    bounds how many times the fault fires (None = until cleared).

    At-rest corruption (corrupt_range): bit-flips in ALREADY-WRITTEN
    bytes of an SST/WAL file — the silent bit-rot model the background
    scrubber and read-path CRC containment are tested against. Applied
    to the PHYSICAL bytes (below any encryption layer), exactly like a
    decaying disk; nothing raises at flip time — detection is the
    storage layer's job.

    Dropped fsyncs (set_drop_fsyncs): flush(fsync=True) silently succeeds
    without durability — the lying-disk model. simulate_crash() then
    applies the loss: append files are truncated to their last truly
    synced size (removed if never synced), whole-file writes revert to
    their last synced content. Files touched only before this env was
    installed are untouched. Rename-based flows (os.replace of a .tmp)
    happen outside the Env and re-track on next open.
    """

    def __init__(self, base: Optional[Env] = None):
        self.base = base if base is not None else Env()
        self._lock = threading.Lock()
        self._faults: Dict[str, dict] = {}   # kind -> {filter, remaining}
        self._drop_fsyncs = False
        self._fsync_filter = ""
        # append files: path -> [synced_size, existed_at_first_open]
        self._synced: Dict[str, list] = {}
        # whole-file writes under dropped fsyncs: path -> prior raw bytes
        # (None = file did not exist)
        self._whole: Dict[str, Optional[bytes]] = {}
        self.faults_injected = 0
        self.corruptions_injected = 0

    # -------------------------------------------------- at-rest corruption
    def corrupt_range(self, path: str, offset: Optional[int] = None,
                      length: int = 1, nbits: int = 1) -> List[int]:
        """Flip ``nbits`` bits spread over ``[offset, offset+length)`` of
        the file's PHYSICAL bytes in place (read-modify-write below any
        Env layering) — silent at-rest bit rot. offset=None targets the
        middle of the file. Returns the byte offsets flipped."""
        self.corruptions_injected += 1
        return corrupt_file_range(path, offset, length, nbits)

    @property
    def encrypted(self) -> bool:  # type: ignore[override]
        return self.base.encrypted

    # ------------------------------------------------------------- arming
    def set_fault(self, kind: str, path_filter: str = "",
                  count: Optional[int] = None) -> None:
        assert kind in ("read", "append", "append_short", "enospc"), kind
        with self._lock:
            self._faults[kind] = {"filter": path_filter, "remaining": count}

    def clear_fault(self, kind: str) -> None:
        with self._lock:
            self._faults.pop(kind, None)

    def clear_faults(self) -> None:
        with self._lock:
            self._faults.clear()
            self._drop_fsyncs = False

    def set_drop_fsyncs(self, on: bool, path_filter: str = "") -> None:
        with self._lock:
            self._drop_fsyncs = on
            self._fsync_filter = path_filter

    def _should_fire(self, kind: str, path: str) -> bool:
        with self._lock:
            f = self._faults.get(kind)
            if f is None or f["filter"] not in path:
                return False
            if f["remaining"] is not None:
                if f["remaining"] <= 0:
                    return False
                f["remaining"] -= 1
            self.faults_injected += 1
            return True

    def _fsync_dropped(self, path: str) -> bool:
        with self._lock:
            return self._drop_fsyncs and self._fsync_filter in path

    # ----------------------------------------------------- sync tracking
    def _note_open_append(self, path: str) -> None:
        with self._lock:
            if path not in self._synced:
                exists = os.path.exists(path)
                self._synced[path] = [
                    os.path.getsize(path) if exists else 0, exists]

    def _mark_synced(self, path: str) -> None:
        with self._lock:
            rec = self._synced.setdefault(path, [0, True])
            try:
                rec[0] = os.path.getsize(path)
            except OSError:
                pass

    def simulate_crash(self) -> List[str]:
        """Apply unsynced-data loss as a crash would, and reset tracking
        (the 'restarted process' opens files fresh). Returns the paths
        whose bytes were rolled back."""
        with self._lock:
            synced = self._synced
            whole = self._whole
            self._synced = {}
            self._whole = {}
            self._drop_fsyncs = False
        affected = []
        for path, (size, existed) in synced.items():
            if not os.path.exists(path):
                continue
            if os.path.getsize(path) > size:
                affected.append(path)
                if size == 0 and not existed:
                    os.remove(path)
                else:
                    with open(path, "r+b") as f:
                        f.truncate(size)
        for path, prior in whole.items():
            affected.append(path)
            if prior is None:
                if os.path.exists(path):
                    os.remove(path)
            else:
                with open(path, "wb") as f:
                    f.write(prior)
        return affected

    # ------------------------------------------------------------- file ops
    def read_file(self, path: str) -> bytes:
        if self._should_fire("read", path):
            raise FaultError(f"injected read error: {path}")
        return self.base.read_file(path)

    def write_file(self, path: str, data: bytes) -> None:
        import errno
        if self._should_fire("enospc", path):
            raise FaultError(errno.ENOSPC,
                             f"injected ENOSPC writing {path}")
        if self._fsync_dropped(path):
            with self._lock:
                if path not in self._whole:
                    prior = None
                    if os.path.exists(path):
                        with open(path, "rb") as f:
                            prior = f.read()
                    self._whole[path] = prior
        else:
            with self._lock:
                self._whole.pop(path, None)
        self.base.write_file(path, data)
        if not self._fsync_dropped(path):
            self._mark_synced(path)

    def open_random(self, path: str):
        return _FaultRandomAccessFile(self, path, self.base.open_random(path))

    def open_append(self, path: str):
        self._note_open_append(path)
        return _FaultAppendFile(self, path, self.base.open_append(path))


class _FaultRandomAccessFile:
    def __init__(self, env: FaultInjectionEnv, path: str, raw):
        self._env = env
        self._path = path
        self._raw = raw

    def pread(self, size: int, offset: int) -> bytes:
        if self._env._should_fire("read", self._path):
            raise FaultError(f"injected pread error: {self._path}"
                             f" @{offset}+{size}")
        return self._raw.pread(size, offset)

    def size(self) -> int:
        return self._raw.size()

    def close(self) -> None:
        self._raw.close()


class _FaultAppendFile:
    def __init__(self, env: FaultInjectionEnv, path: str, raw):
        self._env = env
        self._path = path
        self._raw = raw

    @property
    def offset(self) -> int:
        return self._raw.offset

    def append(self, data: bytes) -> None:
        import errno
        env, path = self._env, self._path
        if env._should_fire("enospc", path):
            raise FaultError(errno.ENOSPC, f"injected ENOSPC: {path}")
        if env._should_fire("append", path):
            raise FaultError(f"injected append error: {path}")
        if env._should_fire("append_short", path):
            self._raw.append(data[: max(1, len(data) // 2)])
            raise FaultError(f"injected short (torn) append: {path}")
        self._raw.append(data)

    def flush(self, fsync: bool = True) -> None:
        if fsync and self._env._fsync_dropped(self._path):
            # lying disk: bytes reach the OS (still readable) but the
            # durability claim is false — simulate_crash() collects them
            self._raw.flush(fsync=False)
            return
        self._raw.flush(fsync=fsync)
        if fsync:
            self._env._mark_synced(self._path)

    def close(self) -> None:
        self._raw.close()


def corrupt_file_range(path: str, offset: Optional[int] = None,
                       length: int = 1, nbits: int = 1) -> List[int]:
    """Flip ``nbits`` bits over ``[offset, offset+length)`` of ``path``'s
    physical bytes (see FaultInjectionEnv.corrupt_range, which delegates
    here so tests without a fault env can corrupt too). Deterministic:
    flipped offsets are evenly spread over the range, one bit (cycling
    bit position by index) per byte."""
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"cannot corrupt empty file {path}")
    if offset is None:
        offset = size // 2
    offset = max(0, min(offset, size - 1))
    length = max(1, min(length, size - offset))
    nbits = max(1, nbits)
    step = max(1, length // nbits)
    flipped: List[int] = []
    with open(path, "r+b") as f:
        for i in range(nbits):
            off = offset + min(i * step, length - 1)
            if off >= size:
                break
            f.seek(off)
            (b,) = f.read(1)
            f.seek(off)
            f.write(bytes([b ^ (1 << (i % 8))]))
            flipped.append(off)
        f.flush()
        os.fsync(f.fileno())
    return flipped


# ------------------------------------------------------------ process env
_env: Env = Env()


def get_env() -> Env:
    return _env


def set_env(env: Env) -> None:
    global _env
    _env = env


def enable_encryption(keys: UniverseKeys) -> None:
    set_env(EncryptedEnv(keys))


def disable_encryption() -> None:
    set_env(Env())


def enable_fault_injection(base: Optional[Env] = None) -> FaultInjectionEnv:
    """Stack a FaultInjectionEnv over `base` (default: the current process
    env, so it composes with encryption) and install it. Returns the
    wrapper for arming."""
    fi = FaultInjectionEnv(base if base is not None else _env)
    set_env(fi)
    return fi


def disable_fault_injection() -> None:
    if isinstance(_env, FaultInjectionEnv):
        set_env(_env.base)
