"""Build and load the port's CUDA kernels; checks shared by their
wrappers.

Every ``*.cu`` file under ``egc_tpu_torch/csrc/`` becomes one shared
library with a plain C interface, compiled by ``nvcc`` for ``sm_90a`` and
loaded with ``ctypes``; the ``*.cuh`` headers beside them hold device
helpers that several sources include. The sources include no PyTorch
header, so a build takes seconds. All sources build at once, one ``nvcc``
process each, into ``egc_tpu_torch/_build/`` (listed in ``.gitignore``); a
library's file name carries the hash of its source, the headers and the
flags, so an edited source or header is rebuilt and an unchanged one is
reused. The staleness check and the compiles run under an exclusive
``fcntl.flock`` on ``_build/.lock``, so processes that start on a cold
cache together (search workers, ranks) compile each source once: the
first builds, the others wait and then find the libraries there. Each
``.log`` is written by the process that built its library. The operating
system drops the lock of a process that dies.

Nothing is built when a module is imported: ``library(name)`` builds on
first use, which is the first launch of a kernel on a CUDA tensor.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: Optional[float] = None


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return found


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every stale source in parallel; returns name -> library
    path. Raises with the compiler's output if any build fails. The
    ``ptxas -v`` report of each build is kept beside it as ``.log``.
    Holds ``_build/.lock`` throughout; ``build_seconds`` counts the wait
    for it too."""
    global build_seconds
    t0 = time.perf_counter()
    with build_lock():
        targets = _compile_stale()
    build_seconds = time.perf_counter() - t0
    return targets


@contextlib.contextmanager
def build_lock():
    """Hold the exclusive ``fcntl.flock`` on ``_build/.lock`` (every native
    build of the package runs under it)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _compile_stale() -> Dict[str, Path]:
    targets = {src.stem: (src, _target(src))
               for src in sorted(CSRC.glob("*.cu"))}
    procs = {}
    for name, (src, out) in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        log = open(out.with_suffix(".log"), "w")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=log, stderr=subprocess.STDOUT), tmp, out, log)
    failed = []
    for name, (proc, tmp, out, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{name} (exit {rc}):\n"
                          + out.with_suffix(".log").read_text())
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: out for name, (_, out) in targets.items()}


def _kernel_name(mangled: str) -> str:
    """``gatv2_bwd_t_kernel<14, 2>`` from a mangled entry name (integer
    and bool template arguments only)."""
    found = []   # (name, rest) of every <length><name> ending in _kernel
    for i in range(len(mangled)):
        m = re.match(r"\d+", mangled[i:])
        if m is None:
            continue
        start = i + m.end()
        name = mangled[start:start + int(m.group())]
        if name.endswith("_kernel") and name.isidentifier():
            found.append((name, mangled[start + len(name):]))
    if not found:
        return mangled
    name, rest = min(found, key=lambda f: len(f[0]))   # a hash may alias
    targs = re.match(r"I((?:L[ib]\d+E)+)E", rest)
    args = re.findall(r"L([ib])(\d+)E", targs.group(1)) if targs else []
    shown = [("true" if v == "1" else "false") if t == "b" else v
             for t, v in args]
    return name + (f"<{', '.join(shown)}>" if shown else "")


def ptxas_summary(report: str) -> List[str]:
    """One line per kernel of a ``ptxas -v`` report: its name, registers,
    spill bytes and static shared memory."""
    out, name, spill = [], None, ""
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = _kernel_name(entry.group(1))
        elif "spill stores" in line:
            spill = line.split(",", 1)[1].strip()
        else:
            regs = re.search(r"Used (\d+) registers", line)
            if regs and name is not None:
                smem = re.search(r"(\d+) bytes smem", line)
                out.append(f"{name}: {regs.group(1)} registers, {spill}, "
                           f"{smem.group(1) if smem else 0} bytes smem")
                name, spill = None, ""
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    with _lock:
        if not _libs:
            for lib_name, path in build_all().items():
                _libs[lib_name] = ctypes.CDLL(str(path))
        if name not in _libs:
            raise KeyError(f"no CUDA source csrc/{name}.cu")
        return _libs[name]


def check_tensor(name: str, t, dtype, device, shape=None) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``device``
    (of ``shape``, when given): what a kernel's pointers assume."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def check_launch(err: int, kernel: str, lib: ctypes.CDLL) -> None:
    """Raise if a C entry point returned a nonzero ``cudaError_t``."""
    if err != 0:
        fn = lib.egc_cuda_error_string
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"CUDA kernel {kernel} failed: cudaError_t {err} "
                           f"({fn(err).decode()})")
