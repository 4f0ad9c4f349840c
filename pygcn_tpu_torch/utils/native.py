"""ctypes bindings for the repo's graphkit native library (``native/graphkit.cpp``).

The port keeps its own wrapper around the shared library the JAX package
also uses (same source, same ``native/build.sh`` g++ build), limited to the
entry points the port's paths need: the bucketed-ELL layout builder,
weighted label propagation, the edge-list parser of the Planetoid
structure loader, and the two host steps of neighbourhood sampling
(``ops/sampling.py``): :func:`sample_layer` (fixed-fanout picks, the CSR
gather and the aggregation weights in one pass, row-parallel on request)
and :func:`unique_inverse` (the per-layer dedup and relabel). Each has a
NumPy fallback; ``available()`` reports which path runs. The two
label-propagation paths give the same labels, but
``partition.locality_order("auto")`` picks BFS instead of LP when the
library is missing, which changes the node order and so the share of edges
that land on hybrid tiles. The sampling paths give the same bits: a pick is
the counter hash ``splitmix64(base + i*k + j) % deg`` in wrapping uint64
arithmetic on every path, native at any thread count or NumPy. The native
calls release the GIL (ctypes), so a prefetch thread's sampling overlaps
the caller's work.
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
_SYMBOLS = ("gk_build_ell_count", "gk_build_ell_fill", "gk_label_propagation",
            "gk_unique_inverse", "gk_unique_inverse_bounded", "gk_sample_layer")
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
    lib.gk_unique_inverse.argtypes = [_i64p, ctypes.c_int64, _i64p, _i64p]
    lib.gk_unique_inverse.restype = ctypes.c_int64
    lib.gk_unique_inverse_bounded.argtypes = [
        _i64p, ctypes.c_int64, ctypes.c_int64, _i32p, _i64p, _i64p,
    ]
    lib.gk_unique_inverse_bounded.restype = ctypes.c_int64
    lib.gk_sample_layer.argtypes = [
        _i64p, _i64p, _f32p, _i64p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_uint64, ctypes.c_int32, _i64p, _f32p,
    ]
    lib.gk_sample_layer.restype = None
    if hasattr(lib, "gk_sample_layer_mt"):
        lib.gk_sample_layer_mt.argtypes = [
            _i64p, _i64p, _f32p, _i64p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_uint64, ctypes.c_int32, ctypes.c_int64, _i64p, _f32p,
        ]
        lib.gk_sample_layer_mt.restype = None
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


def unique_inverse(
    vals: np.ndarray,
    n_max: Optional[int] = None,
    scratch: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """``np.unique(vals, return_inverse=True)`` (sorted unique values, int64
    inverse), the same arrays on every path.

    With ``n_max`` (values known to lie in ``[0, n_max)``: node ids) a dense
    rank table replaces the sort; a zeroed int32 ``scratch`` of size
    ``n_max`` reuses the table across calls (it comes back zeroed). The table
    is indexed by value without a bound check, so values outside the range
    raise ``ValueError`` before the call. Without ``n_max`` a hash kernel
    runs (only the unique keys are sorted).
    """
    v = np.ascontiguousarray(vals, np.int64)
    lib = _load()
    if lib is None or v.size == 0:
        uniq, inv = np.unique(v, return_inverse=True)
        return uniq, inv.astype(np.int64, copy=False)
    uniq = np.empty(v.size, np.int64)
    inv = np.empty(v.size, np.int64)
    if n_max is not None:
        lo, hi = int(v.min()), int(v.max())
        if lo < 0 or hi >= n_max:
            raise ValueError(f"unique_inverse: values in [{lo}, {hi}] outside [0, {n_max})")
        if scratch is None:
            scratch = np.zeros(n_max, np.int32)
        n_uniq = lib.gk_unique_inverse_bounded(
            _ptr(v, _i64p), v.size, n_max, _ptr(scratch, _i32p),
            _ptr(uniq, _i64p), _ptr(inv, _i64p),
        )
    else:
        n_uniq = lib.gk_unique_inverse(_ptr(v, _i64p), v.size, _ptr(uniq, _i64p),
                                       _ptr(inv, _i64p))
    return uniq[:n_uniq], inv


_U64 = np.uint64


def _mix64_np(x: np.ndarray) -> np.ndarray:
    """:func:`_mix64` over a uint64 array (NumPy's uint64 products wrap)."""
    x = x + _U64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> _U64(27))) * _U64(0x94D049BB133111EB)
    return x ^ (x >> _U64(31))


def _auto_sample_threads(m: int, k: int) -> int:
    """Threads for the row-parallel sampling kernel: one per 131,072 draws,
    at most one per core. A draw is mostly a random read of the CSR, so a
    thread pays only once it owns enough of them; the thread count changes
    no bit of the result, only the time."""
    cores = os.cpu_count() or 1
    return max(1, min(cores, (m * k) // 131072))


def sample_layer(
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    out_nodes: np.ndarray,
    k: int,
    base: int,
    mode: str = "gcn",
    threads: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """``k`` neighbour picks for each of ``out_nodes`` over a CSR adjacency:
    ``(cols [m, k] int64, weights [m, k] float32)``.

    Pick ``(i, j)`` is ``indices[indptr[node] + splitmix64(base + i*k + j) %
    deg]``; its weight is the edge's value times ``deg / k`` (``mode='gcn'``:
    an unbiased estimate of the ``A_hat`` row) or ``1 / k`` (``'mean'``).
    A row of degree zero emits the node itself with weight 0. One fused
    native pass, row-parallel over ``threads`` (None: by batch size,
    :func:`_auto_sample_threads`), or the NumPy fallback: the same bits.
    """
    m = int(out_nodes.size)
    mode_i = 0 if mode == "gcn" else 1
    lib = _load()
    if lib is not None:
        nodes = np.ascontiguousarray(out_nodes, np.int64)
        cols = np.empty((m, k), np.int64)
        wts = np.empty((m, k), np.float32)
        csr = (_ptr(np.ascontiguousarray(indptr, np.int64), _i64p),
               _ptr(np.ascontiguousarray(indices, np.int64), _i64p),
               _ptr(np.ascontiguousarray(data, np.float32), _f32p))
        n_threads = _auto_sample_threads(m, k) if threads is None else max(1, threads)
        if n_threads > 1 and hasattr(lib, "gk_sample_layer_mt"):
            lib.gk_sample_layer_mt(*csr, _ptr(nodes, _i64p), m, k, ctypes.c_uint64(base & _M64),
                                   mode_i, n_threads, _ptr(cols, _i64p), _ptr(wts, _f32p))
        else:
            lib.gk_sample_layer(*csr, _ptr(nodes, _i64p), m, k, ctypes.c_uint64(base & _M64),
                                mode_i, _ptr(cols, _i64p), _ptr(wts, _f32p))
        return cols, wts

    nodes = np.asarray(out_nodes, np.int64)
    deg = indptr[nodes + 1] - indptr[nodes]
    counters = (_U64(base & _M64)
                + (np.arange(m, dtype=np.uint64) * _U64(k))[:, None]
                + np.arange(k, dtype=np.uint64)[None, :])
    picks = (_mix64_np(counters)
             % np.maximum(deg, 1).astype(np.uint64)[:, None]).astype(np.int64)
    if indices.size == 0:  # edgeless graph: every row has degree zero
        return nodes[:, None].repeat(k, 1), np.zeros((m, k), np.float32)
    # a row of degree zero at the end of the CSR would read past `indices`:
    # clamp the gather (those rows are overwritten below)
    flat = np.minimum(indptr[nodes][:, None] + picks, indices.size - 1)
    cols = indices[flat].astype(np.int64, copy=False)
    w = data[flat].astype(np.float32, copy=False)
    if mode_i == 0:
        wts = w * (deg[:, None].astype(np.float32) / np.float32(k))
    else:
        wts = np.full((m, k), 1.0 / k, np.float32)
    has_edges = deg > 0
    wts = np.where(has_edges[:, None], wts, 0.0).astype(np.float32)
    cols = np.where(has_edges[:, None], cols, nodes[:, None])
    return cols, wts
