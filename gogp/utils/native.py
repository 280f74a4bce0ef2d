"""ctypes bindings for the native (C++) runtime helpers.

The compute path is JAX/XLA; the host-side runtime around it uses
C++ where throughput matters — currently the CSV data loader (reference
``load``, tutorial/tutorial.go:234-272).  Built by ``make native`` (g++,
no pybind11 — plain C ABI through ctypes); every caller falls back to the
pure-Python implementation transparently when the shared object has not
been built (gogp/tutorial/io.py).
"""

from __future__ import annotations

import ctypes
import pathlib

import numpy as np

_LIB_PATH = pathlib.Path(__file__).resolve().parents[2] / "native" / "libgogp_native.so"

_lib = None


def _load():
    global _lib
    if _lib is None:
        if not _LIB_PATH.exists():
            raise ImportError(
                f"native library not built (run `make native` to create {_LIB_PATH})"
            )
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.parse_csv.restype = ctypes.c_long
        lib.parse_csv.argtypes = [
            ctypes.c_char_p,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_long),
        ]
        _lib = lib
    return _lib


def parse_csv(text: str) -> np.ndarray:
    """Parse comma-separated float rows -> (n_rows, n_cols) float64 array.

    Raises ValueError on ragged rows or non-numeric fields (the reference
    load() errors likewise, tutorial/tutorial.go:252-259).
    """
    lib = _load()
    raw = text.encode()
    max_vals = len(raw) // 2 + 8
    out = np.empty(max_vals, dtype=np.float64)
    n_cols = ctypes.c_long(0)
    n = lib.parse_csv(
        raw,
        len(raw),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        max_vals,
        ctypes.byref(n_cols),
    )
    if n < 0:
        raise ValueError("malformed CSV (ragged row or non-numeric field)")
    if n == 0 or n_cols.value == 0:
        return np.zeros((0, 1), dtype=np.float64)
    return out[:n].reshape(-1, n_cols.value).copy()
