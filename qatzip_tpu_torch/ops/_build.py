"""Build the port's native libraries at first use.

Two libraries, each built the same way: one compiler process per source,
all started together, then a link:

  * the CUDA kernels with their Python binding, one extension module
    (``_qz_kernels``): each ``qatzip_tpu_torch/csrc/*.cu`` compiled by
    ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -c``, ``binding.c``
    (plain C against ``Python.h`` alone, no PyTorch header) by the host C
    compiler, linked by ``nvcc -shared`` (the CUDA runtime linked
    statically, as nvcc does by default) and imported from its path;
  * the port's own copy of the host C++ runtime (``csrc/qztpu_native.cpp``),
    compiled by ``g++`` and loaded with ctypes (see ``native.py``).

Outputs go to ``build/qatzip_tpu_torch/`` at the repository root, named
by a hash of their sources and command line, so a changed source builds
anew and an unchanged one is loaded as is. A file lock serialises
concurrent builds (several test workers may start at once); the output
appears atomically under its final name. A missing compiler or a failed
build raises; nothing falls back.
"""

from __future__ import annotations

import fcntl
import glob
import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import time
from typing import Callable, List, Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(PKG_DIR)
BUILD_DIR = os.path.join(REPO_DIR, "build", "qatzip_tpu_torch")
CSRC_DIR = os.path.join(PKG_DIR, "csrc")

#: seconds each library took to build in this process (0.0 = cached)
BUILD_SECONDS: dict = {}
#: compiler output of each build in this process (``-Xptxas -v`` for nvcc)
BUILD_LOGS: dict = {}


def _run_all(cmds: Sequence[List[str]]) -> str:
    """Run the commands at once; return their joined output, or raise
    with it when one of them failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    log = "".join(outs)
    if any(p.returncode for p in procs):
        raise RuntimeError(f"build command failed:\n{log}")
    return log


def build_library(name: str, sources: Sequence[str], deps: Sequence[str],
                  compile_one: Callable[[str, str], List[str]],
                  link: Callable[[str, Sequence[str]], List[str]],
                  tag: str = "") -> str:
    """Build (or find) ``name`` and return the path of the shared library.

    ``compile_one(src, obj)`` gives the command that compiles one source
    to an object, every source's command started at once; ``link(out,
    objs)`` the command that links the objects. ``deps`` are further
    files (headers) whose contents, and ``tag``, select the output's
    name."""
    h = hashlib.sha256(tag.encode())
    for path in list(sources) + list(deps):
        with open(path, "rb") as f:
            h.update(f.read())
    for cmd in (compile_one("SRC", "OBJ"), link("OUT", ["OBJ"])):
        h.update("\0".join(cmd).encode())
    out = os.path.join(BUILD_DIR, f"{name}_{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        BUILD_SECONDS.setdefault(name, 0.0)
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):
            BUILD_SECONDS.setdefault(name, 0.0)
            return out
        tmp = f"{out}.tmp{os.getpid()}"
        objs = [f"{tmp}.{i}.o" for i in range(len(sources))]
        t0 = time.perf_counter()
        try:
            log = _run_all([compile_one(s, o) for s, o in zip(sources, objs)])
            log += _run_all([link(tmp, objs)])
        except RuntimeError as e:
            raise RuntimeError(f"building {name} failed: {e}") from None
        finally:
            for o in objs:
                if os.path.exists(o):
                    os.remove(o)
        BUILD_SECONDS[name] = time.perf_counter() - t0
        BUILD_LOGS[name] = log
        os.replace(tmp, out)
        for old in glob.glob(os.path.join(BUILD_DIR, f"{name}_*.so")):
            if old != out:
                os.remove(old)
    return out


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "qatzip_tpu_torch cannot be built")
    return nvcc


def python_include() -> str:
    """The directory of this interpreter's ``Python.h``."""
    inc = sysconfig.get_paths()["include"]
    if not os.path.exists(os.path.join(inc, "Python.h")):
        raise RuntimeError(f"Python.h not found in {inc}: the kernel binding "
                           "of qatzip_tpu_torch cannot be built")
    return inc


def binding_command(src: str, obj: str) -> list:
    """The host compiler's command for the binding's C source."""
    cc = shutil.which("cc") or "gcc"
    return [cc, "-std=c11", "-O2", "-fPIC", "-Wall", "-I", python_include(),
            "-I", CSRC_DIR, "-c", "-o", obj, src]


def kernels_library() -> str:
    """Path of the kernel extension module (the CUDA kernels for sm_90a
    and ``binding.c``), built if needed."""
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    sources.append(os.path.join(CSRC_DIR, "binding.c"))
    nvcc = find_nvcc()
    arch = ["-gencode", "arch=compute_90a,code=sm_90a"]

    def compile_one(src, obj):
        if src.endswith(".c"):
            return binding_command(src, obj)
        return [nvcc, *arch, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                "-Xptxas", "-v", "-c", "-o", obj, src]
    return build_library(
        "qztorch_kernels", sources,
        sorted(glob.glob(os.path.join(CSRC_DIR, "*.h")) +
               glob.glob(os.path.join(CSRC_DIR, "*.cuh"))), compile_one,
        lambda out, objs: [nvcc, *arch, "-shared", "-o", out, *objs],
        tag=" ".join(binding_command("SRC", "OBJ")))


def load_kernels():
    """The kernel extension module, built at first use."""
    path = kernels_library()
    loader = importlib.machinery.ExtensionFileLoader("_qz_kernels", path)
    spec = importlib.util.spec_from_file_location("_qz_kernels", path,
                                                  loader=loader)
    mod = importlib.util.module_from_spec(spec)
    loader.exec_module(mod)
    return mod
