"""Build-on-first-use for the native (C++) components and the CUDA kernels.

The C++ sources are the repository's own `native/*.cc`, compiled unchanged
into this package's build directory (`yugabyte_tpu_torch/build/`, listed in
.gitignore) so that the port never shares `native/build/` with the JAX
package. The CUDA sources live in `yugabyte_tpu_torch/csrc/` and are
compiled with `nvcc` into shared libraries with a plain C interface.

Rebuild rule: when the library is missing, or when its mtime is <= the
newest of its sources (`<=`, not `<`: a fresh checkout gives sources and
any stale binary the same mtime).
"""

from __future__ import annotations

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
    with _lock:
        if _stale(lib, srcs):
            os.makedirs(BUILD_DIR, exist_ok=True)
            subprocess.run(_native_cmd(src_name, lib, extra_args),
                           check=True)
    return lib


def build_cuda_lib(src_name: str) -> str:
    """Compile csrc/<src_name> (a .cu file) into lib<stem>.so if stale."""
    lib = os.path.join(BUILD_DIR, "lib" + src_name.rsplit(".", 1)[0] + ".so")
    with _lock:
        if _stale(lib, [os.path.join(CSRC_DIR, src_name)]):
            os.makedirs(BUILD_DIR, exist_ok=True)
            subprocess.run(_cuda_cmd(src_name, lib), check=True)
    return lib


# every library the compaction slice loads: (kind, source, lib name, args)
NATIVE_LIBS = (("compaction_engine.cc", "libcompaction_engine.so",
                ("-lz", "-lpthread")),
               ("compaction_baseline.cc", "libcompaction_baseline.so", ()))
CUDA_SOURCES = ("merge_path.cu", "gc_pack.cu")


def build_all(cuda: bool = True) -> Dict[str, str]:
    """Build every stale library at once: one compiler process per source,
    all started together. Returns {source: compiler output} for the
    sources that were compiled (nvcc's output carries -Xptxas -v)."""
    jobs = []
    for src, lib_name, extra in NATIVE_LIBS:
        lib = os.path.join(BUILD_DIR, lib_name)
        srcs = [os.path.join(NATIVE_DIR, s) for s in (src, "merge_gc_core.h")]
        if _stale(lib, srcs):
            jobs.append((src, _native_cmd(src, lib, extra)))
    if cuda:
        for src in CUDA_SOURCES:
            lib = os.path.join(BUILD_DIR, "lib" + src.rsplit(".", 1)[0]
                               + ".so")
            if _stale(lib, [os.path.join(CSRC_DIR, src)]):
                jobs.append((src, _cuda_cmd(src, lib)))
    out: Dict[str, str] = {}
    with _lock:
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = [(src, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
                 for src, cmd in jobs]
        failed = []
        for src, p in procs:
            text, _ = p.communicate()
            out[src] = text
            if p.returncode != 0:
                failed.append(f"{src} (exit {p.returncode}):\n{text}")
    if failed:
        raise RuntimeError("build failed: " + "\n".join(failed))
    return out
