"""The native CSV parser behind the on-disk readers (counterpart of
``egc_tpu.native``), bound over ``ctypes``.

``fastcsv.cpp`` is the port's copy of the JAX package's multithreaded
``std::from_chars`` parser; besides, it reports a field that is not a
whole number of the type (JAX's stores 0 there). It is compiled with
``g++`` at first use into ``egc_tpu_torch/_build/`` (listed in
``.gitignore``), under the lock of the package's other native builds
(``ops/cuda/_build.build_lock``); the library's name carries the hash of
the source and the flags, so an edited source is rebuilt. No
``-march=native``: the build directory may move to another machine with
the checkout. A failed build raises: there is no slower fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from egc_tpu_torch.ops.cuda._build import BUILD_DIR, build_lock

SOURCE = Path(__file__).resolve().parent / "fastcsv.cpp"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib = None

_PARSERS = {
    np.dtype(np.float32): ("fastcsv_parse_f32", ctypes.c_float),
    np.dtype(np.float64): ("fastcsv_parse_f64", ctypes.c_double),
    np.dtype(np.int64): ("fastcsv_parse_i64", ctypes.c_int64),
}


def _target() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libfastcsv_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native CSV parser "
                           "(egc_tpu_torch/native/fastcsv.cpp) cannot be "
                           "built")
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    try:
        res = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed for {SOURCE.name} (exit "
                               f"{res.returncode}):\n{res.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)


def library() -> ctypes.CDLL:
    """The loaded parser, built on the first call."""
    global _lib
    with _lock:
        if _lib is None:
            with build_lock():
                out = _target()
                if not out.exists():
                    _build(out)
            lib = ctypes.CDLL(str(out))
            lib.fastcsv_count.restype = ctypes.c_int64
            lib.fastcsv_count.argtypes = [ctypes.c_char_p, ctypes.c_int64]
            lib.fastcsv_check_rows.restype = ctypes.c_int64
            lib.fastcsv_check_rows.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64]
            for name, ctype in _PARSERS.values():
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int64
                fn.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                               ctypes.POINTER(ctype), ctypes.c_int64]
            _lib = lib
        return _lib


def csv_rows_consistent(data: bytes, cols: int) -> int:
    """The number of non-empty CSV rows when every one has exactly
    ``cols`` fields (the parser's separators), else -1."""
    return int(library().fastcsv_check_rows(data, len(data), int(cols)))


def parse_csv_bytes(data: bytes, dtype) -> np.ndarray:
    """Decompressed CSV text -> a flat array of ``dtype``: an integer
    dtype parses as int64, a float one other than float32 / float64 as
    float64, then casts. Raises ``ValueError`` on a field that is not a
    whole number of the parsed type."""
    dtype = np.dtype(dtype)
    key = dtype if dtype in _PARSERS else np.dtype(np.int64) \
        if dtype.kind in "iu" else np.dtype(np.float64) \
        if dtype.kind == "f" else None
    if key is None:
        raise TypeError(f"no CSV parser for dtype {dtype}")
    lib = library()
    n = lib.fastcsv_count(data, len(data))
    name, ctype = _PARSERS[key]
    out = np.empty(n, key)
    got = getattr(lib, name)(data, len(data),
                             out.ctypes.data_as(ctypes.POINTER(ctype)), n)
    if got == -2:
        raise ValueError(f"CSV holds a field that is not a {key} number")
    if got != n:
        raise RuntimeError(f"the CSV parser read {got} of {n} fields")
    return out.astype(dtype, copy=False)
