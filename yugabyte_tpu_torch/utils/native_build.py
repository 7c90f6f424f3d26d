"""Build-on-first-use for the native (C++) components and the CUDA kernels.

The C++ sources are the repository's own `native/*.cc`, compiled unchanged
into this package's build directory (`yugabyte_tpu_torch/build/`, listed in
.gitignore) so that the port never shares `native/build/` with the JAX
package. The CUDA sources live in `yugabyte_tpu_torch/csrc/` and are
compiled with `nvcc` into shared libraries with a plain C interface.

Rebuild rule: when the library is missing, or when its mtime is <= the
newest of its sources (`<=`, not `<`: a fresh checkout gives sources and
any stale binary the same mtime).

Builds are atomic across processes: every build holds an `fcntl` lock
on `build/.build.lock` (and a thread lock within the process), judges
staleness again once it holds the lock, compiles to a temporary name in
the build directory and `os.replace`s it into place. A process that
loads a library therefore never maps one that another process (a test
worker, a concurrent run) is still writing.
"""

from __future__ import annotations

import contextlib
import fcntl
import os
import subprocess
import threading
from typing import Dict, Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PKG_DIR)
NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
LOCK_PATH = os.path.join(BUILD_DIR, ".build.lock")


@contextlib.contextmanager
def _build_lock():
    """Hold the build directory's lock: the thread lock of this process,
    then an exclusive `fcntl` lock on LOCK_PATH shared with every other
    process building into BUILD_DIR."""
    with _lock:
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd = os.open(LOCK_PATH, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)


def _tmp_path(lib: str) -> str:
    """The temporary name a build of `lib` writes before its os.replace."""
    return f"{lib}.tmp{os.getpid()}"


def _run_atomic(cmd_for, lib: str) -> None:
    """Compile `cmd_for(tmp)` and move the result into place as `lib`
    (caller holds _build_lock). The temporary file goes on failure."""
    tmp = _tmp_path(lib)
    try:
        subprocess.run(cmd_for(tmp), check=True)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _stale(lib: str, srcs: Sequence[str]) -> bool:
    newest = max(os.path.getmtime(s) for s in srcs if os.path.exists(s))
    return not os.path.exists(lib) or os.path.getmtime(lib) <= newest


def _native_cmd(src_name: str, lib: str, extra_args: Sequence[str]):
    return ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", lib,
            os.path.join(NATIVE_DIR, src_name), *extra_args]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    return cand if os.path.exists(cand) else "nvcc"


def _cuda_cmd(src_name: str, lib: str):
    return [_nvcc(), *NVCC_FLAGS, "-o", lib, os.path.join(CSRC_DIR, src_name)]


def build_native_lib(src_name: str, lib_name: str,
                     deps: Sequence[str] = ("merge_gc_core.h",),
                     extra_args: Sequence[str] = ()) -> str:
    """Compile native/<src_name> into the port's build dir if stale.

    Returns the .so path; raises CalledProcessError on compile failure."""
    lib = os.path.join(BUILD_DIR, lib_name)
    srcs = [os.path.join(NATIVE_DIR, s) for s in (src_name, *deps)]
    if _stale(lib, srcs):
        with _build_lock():
            if _stale(lib, srcs):  # another process may have built it
                _run_atomic(lambda out: _native_cmd(src_name, out,
                                                    extra_args), lib)
    return lib


def _cuda_srcs(src_name: str):
    """A .cu file and the csrc headers (*.cuh) it may include."""
    return [os.path.join(CSRC_DIR, src_name)] + sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
        if f.endswith(".cuh"))


def build_cuda_lib(src_name: str) -> str:
    """Compile csrc/<src_name> (a .cu file) into lib<stem>.so if stale."""
    lib = os.path.join(BUILD_DIR, "lib" + src_name.rsplit(".", 1)[0] + ".so")
    if _stale(lib, _cuda_srcs(src_name)):
        with _build_lock():
            if _stale(lib, _cuda_srcs(src_name)):
                _run_atomic(lambda out: _cuda_cmd(src_name, out), lib)
    return lib


# every library the compaction, scan, point-read and mesh slices load:
# (source, lib name, args)
NATIVE_LIBS = (("compaction_engine.cc", "libcompaction_engine.so",
                ("-lz", "-lpthread")),
               ("compaction_baseline.cc", "libcompaction_baseline.so", ()),
               ("read_engine.cc", "libread_engine.so", ("-lz",)),
               ("memtable_arena.cc", "libmemtable_arena.so", ()))
CUDA_SOURCES = ("merge_path.cu", "gc_pack.cu", "block_codec.cu",
                "write_through.cu", "radix.cu", "concat.cu", "scan.cu",
                "pushdown.cu", "point_read.cu", "chunk.cu", "dist.cu")


def build_all(cuda: bool = True) -> Dict[str, str]:
    """Build every stale library at once: one compiler process per source,
    all started together, each writing a temporary file that replaces the
    library when it succeeds, under _build_lock (staleness is judged once
    the lock is held). Returns {source: compiler output} for the sources
    that were compiled (nvcc's output carries -Xptxas -v)."""
    out: Dict[str, str] = {}
    failed = []
    with _build_lock():
        jobs = []   # (source, command, temporary path, library)
        for src, lib_name, extra in NATIVE_LIBS:
            lib = os.path.join(BUILD_DIR, lib_name)
            srcs = [os.path.join(NATIVE_DIR, s)
                    for s in (src, "merge_gc_core.h")]
            if _stale(lib, srcs):
                tmp = _tmp_path(lib)
                jobs.append((src, _native_cmd(src, tmp, extra), tmp, lib))
        if cuda:
            for src in CUDA_SOURCES:
                lib = os.path.join(BUILD_DIR, "lib" + src.rsplit(".", 1)[0]
                                   + ".so")
                if _stale(lib, _cuda_srcs(src)):
                    tmp = _tmp_path(lib)
                    jobs.append((src, _cuda_cmd(src, tmp), tmp, lib))
        procs = [(src, tmp, lib,
                  subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True))
                 for src, cmd, tmp, lib in jobs]
        for src, tmp, lib, p in procs:
            text, _ = p.communicate()
            out[src] = text
            if p.returncode == 0:
                os.replace(tmp, lib)
            else:
                failed.append(f"{src} (exit {p.returncode}):\n{text}")
                if os.path.exists(tmp):
                    os.remove(tmp)
    if failed:
        raise RuntimeError("build failed: " + "\n".join(failed))
    return out
