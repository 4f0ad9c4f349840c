"""ctypes bindings for the repo's graphkit native library (``native/graphkit.cpp``).

The port keeps its own wrapper around the shared library the JAX package
also uses (same source, same ``native/build.sh`` g++ build), limited to the
entry points the port's paths need: the bucketed-ELL layout builder,
weighted label propagation and the edge-list parser of the Planetoid
structure loader. Each has a NumPy fallback;
``available()`` reports which path runs. The two label-propagation paths give
the same labels, but ``partition.locality_order("auto")`` picks BFS instead of
LP when the library is missing, which changes the node order and so the
share of edges that land on hybrid tiles.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Sequence, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native"
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libgraphkit.so")
_SYMBOLS = ("gk_build_ell_count", "gk_build_ell_fill", "gk_label_propagation")
_lib: Optional[ctypes.CDLL] = None
_tried = False

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)


def _needs_build() -> bool:
    """True when the .so is absent or older than graphkit.cpp."""
    if not os.path.exists(_LIB_PATH):
        return True
    src = os.path.join(_NATIVE_DIR, "graphkit.cpp")
    try:
        return os.path.getmtime(src) > os.path.getmtime(_LIB_PATH)
    except OSError:
        return False


def _build() -> bool:
    script = os.path.join(_NATIVE_DIR, "build.sh")
    if not os.path.exists(script):
        return False
    try:
        subprocess.run(["sh", script], check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, OSError):
        return False
    return os.path.exists(_LIB_PATH)


def _open() -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    return lib if all(hasattr(lib, s) for s in _SYMBOLS) else None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if _needs_build() and not _build() and not os.path.exists(_LIB_PATH):
        return None
    lib = _open()
    if lib is None and _build():  # stale library without the needed symbols
        lib = _open()
    if lib is None:
        return None
    lib.gk_build_ell_count.argtypes = [_i64p, ctypes.c_int64, _i64p, ctypes.c_int64, _i64p]
    lib.gk_build_ell_count.restype = None
    lib.gk_build_ell_fill.argtypes = [
        _i64p, _i64p, _f32p, ctypes.c_int64, _i64p, ctypes.c_int64,
        ctypes.POINTER(_i32p), ctypes.POINTER(_f32p), ctypes.POINTER(_i32p),
    ]
    lib.gk_build_ell_fill.restype = None
    lib.gk_label_propagation.argtypes = [
        _i64p, _i64p, _f32p, ctypes.c_int64, ctypes.c_int64, _i64p,
    ]
    lib.gk_label_propagation.restype = ctypes.c_int64
    if hasattr(lib, "gk_parse_edge_list"):
        lib.gk_parse_edge_list.argtypes = [ctypes.c_char_p, _i64p, _i64p, ctypes.c_int64]
        lib.gk_parse_edge_list.restype = ctypes.c_int64
    _lib = lib
    return _lib


def available() -> bool:
    """Whether the native library loaded (else the NumPy fallbacks run)."""
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctype)


def parse_edge_list(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """The two int64 columns of a whitespace-separated edge list (a
    Planetoid ``.cites`` file: ``<cited> <citing>`` a line).

    ``gk_parse_edge_list`` when the library has it (two passes: count, then
    fill), else NumPy's ``genfromtxt`` (the JAX package's fallback,
    ``pygcn_tpu/graph/datasets.py``). Both give the same arrays.
    """
    lib = _load()
    if lib is None or not hasattr(lib, "gk_parse_edge_list"):
        raw = np.genfromtxt(path, dtype=np.int64).reshape(-1, 2)
        return raw[:, 0], raw[:, 1]
    n = lib.gk_parse_edge_list(path.encode(), None, None, 0)
    if n < 0:
        raise FileNotFoundError(path)
    a = np.empty(n, np.int64)
    b = np.empty(n, np.int64)
    got = lib.gk_parse_edge_list(path.encode(), _ptr(a, _i64p), _ptr(b, _i64p), n)
    return a[:got], b[:got]


def build_ell_layout(
    indptr: np.ndarray, indices: np.ndarray, data: np.ndarray, ks: Sequence[int],
) -> Optional[Tuple[list, list, list]]:
    """Per-bucket (cols [Nb,K], vals [Nb,K], rows [Nb]) arrays; None → NumPy."""
    lib = _load()
    if lib is None:
        return None
    n_rows = indptr.size - 1
    indptr64 = np.ascontiguousarray(indptr, np.int64)
    indices64 = np.ascontiguousarray(indices, np.int64)
    data32 = np.ascontiguousarray(data, np.float32)
    ks64 = np.ascontiguousarray(ks, np.int64)

    counts = np.zeros(len(ks), np.int64)
    lib.gk_build_ell_count(_ptr(indptr64, _i64p), n_rows, _ptr(ks64, _i64p),
                           len(ks), _ptr(counts, _i64p))
    cols, vals, rows = [], [], []
    col_ptrs = (_i32p * len(ks))()
    val_ptrs = (_f32p * len(ks))()
    row_ptrs = (_i32p * len(ks))()
    for b, k in enumerate(ks):
        nb = max(int(counts[b]), 1)
        cols.append(np.zeros((nb, k), np.int32))
        vals.append(np.zeros((nb, k), np.float32))
        rows.append(np.zeros(nb, np.int32))
        col_ptrs[b] = cols[b].ctypes.data_as(_i32p)
        val_ptrs[b] = vals[b].ctypes.data_as(_f32p)
        row_ptrs[b] = rows[b].ctypes.data_as(_i32p)
    lib.gk_build_ell_fill(
        _ptr(indptr64, _i64p), _ptr(indices64, _i64p), _ptr(data32, _f32p),
        n_rows, _ptr(ks64, _i64p), len(ks), col_ptrs, val_ptrs, row_ptrs,
    )
    return cols, vals, rows


def label_propagation(
    indptr: np.ndarray,
    indices: np.ndarray,
    weights: Optional[np.ndarray] = None,
    max_iters: int = 20,
) -> np.ndarray:
    """Community labels via weighted asynchronous label propagation over CSR.

    Native when available; otherwise a NumPy sweep with the same
    deterministic semantics (natural node order; switch only on a strictly
    larger vote; among non-current ties prefer the larger splitmix64 hash).
    """
    n_rows = indptr.size - 1
    lib = _load()
    if lib is not None:
        indptr64 = np.ascontiguousarray(indptr, np.int64)
        indices64 = np.ascontiguousarray(indices, np.int64)
        labels = np.empty(n_rows, np.int64)
        w32 = None if weights is None else np.ascontiguousarray(weights, np.float32)
        wp = None if w32 is None else _ptr(w32, _f32p)
        lib.gk_label_propagation(
            _ptr(indptr64, _i64p), _ptr(indices64, _i64p), wp,
            n_rows, max_iters, _ptr(labels, _i64p),
        )
        return labels

    labels = np.arange(n_rows, dtype=np.int64)
    w = (np.ones(indices.size, np.float32) if weights is None
         else np.asarray(weights, np.float32))
    for _ in range(max_iters):
        changed = 0
        for u in range(n_rows):
            lo, hi = int(indptr[u]), int(indptr[u + 1])
            if lo == hi:
                continue
            votes: dict = {}
            for lab, wt in zip(labels[indices[lo:hi]], w[lo:hi]):
                lab = int(lab)
                votes[lab] = np.float32(votes.get(lab, np.float32(0.0)) + np.float32(wt))
            cur = int(labels[u])
            best, best_v = cur, votes.get(cur, np.float32(0.0))
            best_h = 0
            for lab, v in votes.items():
                if v < best_v or lab == best:
                    continue
                h = _mix64(lab)
                if v > best_v or (best != cur and h > best_h):
                    best, best_v, best_h = lab, v, h
            if best != cur:
                labels[u] = best
                changed += 1
        if changed == 0:
            break
    return labels


_M64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64 — must match ``gk_mix64`` in native/graphkit.cpp exactly."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)
