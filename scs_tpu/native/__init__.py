"""Native host-side runtime (C++ via ctypes).

Counterpart of the reference's native runtime layer around its compute
core (scs_source/linsys/scs_matrix.c, csparse.c for CSC plumbing and
scs_source/src/rw.c for binary problem serialization). The device
compute path stays in JAX/XLA; this layer covers the host-side data
plumbing where the reference also uses native code.

The shared library is compiled from csc_ops.cpp on first use with g++
(no pybind11 in the image — plain C ABI + ctypes) and cached next to the
source; if the toolchain is unavailable everything falls back to the
pure-Python implementations at the call sites (`native.available` is
False then).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "csc_ops.cpp")
_SO = os.path.join(_DIR, "_scs_native.so")

_lib = None
available = False

_i64p = ctypes.POINTER(ctypes.c_int64)
_f64p = ctypes.POINTER(ctypes.c_double)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def _build():
    # Build to a process-unique temp name, then atomically install: two
    # processes importing concurrently (parallel pytest workers) would
    # otherwise interleave g++ output into one shared ".tmp" path and
    # os.replace could install a corrupt .so (ADVICE r1).
    import tempfile

    fd, tmp = tempfile.mkstemp(suffix=".so", prefix="_scs_native_", dir=_DIR)
    os.close(fd)
    try:
        cmd = [
            "g++", "-O3", "-std=c++17", "-shared", "-fPIC",
            "-fno-math-errno", "-funroll-loops",
            _SRC, "-o", tmp,
        ]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _bind(lib):
    """Declare ctypes signatures. Raises AttributeError if the .so is a
    stale build missing a symbol — callers treat that as 'rebuild'."""
    lib.csc_has_lower_tri.restype = ctypes.c_int64
    lib.csc_has_lower_tri.argtypes = [_i64p, _i64p, ctypes.c_int64]
    lib.csc_validate.restype = ctypes.c_int64
    lib.csc_validate.argtypes = [_i64p, _i64p, ctypes.c_int64, ctypes.c_int64]
    lib.csc_to_dense.restype = None
    lib.csc_to_dense.argtypes = [
        ctypes.c_int64, ctypes.c_int64, _f64p, _i64p, _i64p, _f64p]
    lib.csc_triu_to_dense_sym.restype = None
    lib.csc_triu_to_dense_sym.argtypes = [
        ctypes.c_int64, _f64p, _i64p, _i64p, _f64p]
    lib.csc_matvec.restype = None
    lib.csc_matvec.argtypes = [
        ctypes.c_int64, ctypes.c_int64, _f64p, _i64p, _i64p, _f64p, _f64p]
    lib.csc_rmatvec.restype = None
    lib.csc_rmatvec.argtypes = [
        ctypes.c_int64, ctypes.c_int64, _f64p, _i64p, _i64p, _f64p, _f64p]
    lib.bell_count.restype = None
    lib.bell_count.argtypes = [
        ctypes.c_int64, ctypes.c_int64, _i64p, _i64p, ctypes.c_int64,
        _i64p, _u8p]
    lib.bell_fill.restype = None
    lib.bell_fill.argtypes = [
        ctypes.c_int64, ctypes.c_int64, _f64p, _i64p, _i64p,
        ctypes.c_int64, ctypes.c_int64, _f64p, _i64p]
    lib.write_problem_bin.restype = ctypes.c_int64
    lib.write_problem_bin.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, _f64p, _f64p,
        ctypes.c_int64, _i64p, _i64p, _f64p,
        ctypes.c_int64, ctypes.c_int64, _i64p, _i64p, _f64p,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_char_p), _f64p,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_char_p), _i64p, _f64p]
    lib.read_problem_header.restype = ctypes.c_int64
    lib.read_problem_header.argtypes = [
        ctypes.c_char_p, _i64p, _i64p, _i64p, _i64p, _i64p]
    lib.read_problem_body.restype = ctypes.c_int64
    lib.read_problem_body.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, _f64p, _f64p, _i64p, _i64p, _f64p,
        _i64p, _i64p, _f64p, _u8p, ctypes.c_int64, _i64p]


def _load():
    global _lib, available
    if _lib is not None:
        return _lib
    try:
        if (not os.path.exists(_SO)
                or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            _build()
        lib = ctypes.CDLL(_SO)
        try:
            _bind(lib)
        except AttributeError:
            # stale-but-newer .so missing a symbol: rebuild once, re-bind
            _build()
            lib = ctypes.CDLL(_SO)
            _bind(lib)
    except Exception:
        available = False
        return None

    _lib = lib
    available = True
    return lib


def _as_i64(a):
    return np.ascontiguousarray(a, dtype=np.int64)


def _as_f64(a):
    return np.ascontiguousarray(a, dtype=np.float64)


def _ptr(a, typ):
    return a.ctypes.data_as(typ)


def has_lower_tri(indptr, indices, ncols) -> bool:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    ip, ix = _as_i64(indptr), _as_i64(indices)
    return bool(lib.csc_has_lower_tri(_ptr(ip, _i64p), _ptr(ix, _i64p), ncols))


def validate_csc(indptr, indices, nrows, ncols) -> bool:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    ip, ix = _as_i64(indptr), _as_i64(indices)
    return bool(lib.csc_validate(_ptr(ip, _i64p), _ptr(ix, _i64p), nrows, ncols))


def csc_to_dense(A) -> np.ndarray:
    """Dense row-major (m, n) from a scipy CSC matrix (one native pass)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    m, n = A.shape
    data, ix, ip = _as_f64(A.data), _as_i64(A.indices), _as_i64(A.indptr)
    out = np.empty((m, n), np.float64)
    lib.csc_to_dense(m, n, _ptr(data, _f64p), _ptr(ix, _i64p),
                     _ptr(ip, _i64p), _ptr(out, _f64p))
    return out


def csc_triu_to_dense_sym(P) -> np.ndarray:
    """Full symmetric dense (n, n) from an upper-triangular CSC P."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    n = P.shape[0]
    data, ix, ip = _as_f64(P.data), _as_i64(P.indices), _as_i64(P.indptr)
    out = np.empty((n, n), np.float64)
    lib.csc_triu_to_dense_sym(n, _ptr(data, _f64p), _ptr(ix, _i64p),
                              _ptr(ip, _i64p), _ptr(out, _f64p))
    return out


def csc_matvec(A, x) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    m, n = A.shape
    data, ix, ip = _as_f64(A.data), _as_i64(A.indices), _as_i64(A.indptr)
    xv = _as_f64(x)
    y = np.empty(m, np.float64)
    lib.csc_matvec(m, n, _ptr(data, _f64p), _ptr(ix, _i64p), _ptr(ip, _i64p),
                   _ptr(xv, _f64p), _ptr(y, _f64p))
    return y


def csc_rmatvec(A, x) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    m, n = A.shape
    data, ix, ip = _as_f64(A.data), _as_i64(A.indices), _as_i64(A.indptr)
    xv = _as_f64(x)
    y = np.empty(n, np.float64)
    lib.csc_rmatvec(m, n, _ptr(data, _f64p), _ptr(ix, _i64p), _ptr(ip, _i64p),
                    _ptr(xv, _f64p), _ptr(y, _f64p))
    return y


def pack_block_ell(A, block_size: int):
    """Pack a scipy CSC matrix into block-ELL form.

    Returns (blocks, cols) with blocks: (nbr, width, bs, bs) f64 and
    cols: (nbr, width) i64 block-column ids (padding slots point at
    block-column 0 with all-zero data). This is the host-side packer for
    the Pallas block-SpMV kernel (ops/sparse.py).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    m, n = A.shape
    bs = int(block_size)
    nbr = -(-m // bs)
    data, ix, ip = _as_f64(A.data), _as_i64(A.indices), _as_i64(A.indptr)
    counts = np.zeros(nbr, np.int64)
    scratch = np.zeros(1, np.uint8)
    lib.bell_count(m, n, _ptr(ix, _i64p), _ptr(ip, _i64p), bs,
                   _ptr(counts, _i64p), _ptr(scratch, _u8p))
    width = max(int(counts.max()) if nbr else 0, 1)
    blocks = np.zeros((nbr, width, bs, bs), np.float64)
    cols = np.zeros((nbr, width), np.int64)
    lib.bell_fill(m, n, _ptr(data, _f64p), _ptr(ix, _i64p), _ptr(ip, _i64p),
                  bs, width, _ptr(blocks, _f64p), _ptr(cols, _i64p))
    return blocks, cols


def write_problem_bin(path, data, cone, settings_dict):
    """Native binary problem snapshot — the rw.c analogue
    (/root/reference source: scs_source/src/rw.c per meson.build:193;
    write_data_filename semantics at scsobject.h:493). Stores (b, c, A
    CSC, optional P CSC triu, numeric settings, cone dict) in one
    little-endian file; see csc_ops.cpp for the layout."""
    from scipy import sparse  # noqa: PLC0415

    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    A = sparse.csc_matrix(data["A"])
    b = _as_f64(data["b"]).ravel()
    c = _as_f64(data["c"]).ravel()
    m, n = A.shape
    P = data.get("P")
    has_p = P is not None
    if has_p:
        P = sparse.csc_matrix(P)
        p_ip, p_ix, p_dat = _as_i64(P.indptr), _as_i64(P.indices), _as_f64(P.data)
        p_nnz = P.nnz
    else:
        p_ip = p_ix = np.zeros(1, np.int64)
        p_dat = np.zeros(1, np.float64)
        p_nnz = 0

    stg_items = [
        (k, float(v))
        for k, v in settings_dict.items()
        if isinstance(v, (int, float, bool)) and not isinstance(v, str)
    ]
    stg_names = (ctypes.c_char_p * max(len(stg_items), 1))(
        *[k.encode() for k, _ in stg_items]
    )
    stg_vals = _as_f64([v for _, v in stg_items] or [0.0])

    cone_items = []
    for k, v in cone.items():
        arr = np.atleast_1d(np.asarray(v, np.float64)).ravel()
        cone_items.append((k, arr))
    cone_names = (ctypes.c_char_p * max(len(cone_items), 1))(
        *[k.encode() for k, _ in cone_items]
    )
    cone_lens = _as_i64([len(a) for _, a in cone_items] or [0])
    cone_data = _as_f64(
        np.concatenate([a for _, a in cone_items]) if cone_items else [0.0]
    )

    rc = lib.write_problem_bin(
        str(path).encode(), m, n, _ptr(b, _f64p), _ptr(c, _f64p),
        A.nnz, _ptr(_as_i64(A.indptr), _i64p), _ptr(_as_i64(A.indices), _i64p),
        _ptr(_as_f64(A.data), _f64p),
        int(has_p), p_nnz, _ptr(p_ip, _i64p), _ptr(p_ix, _i64p),
        _ptr(p_dat, _f64p),
        len(stg_items), stg_names, _ptr(stg_vals, _f64p),
        len(cone_items), cone_names, _ptr(cone_lens, _i64p),
        _ptr(cone_data, _f64p),
    )
    if rc != 0:
        raise IOError(f"write_problem_bin failed with code {rc}")


def read_problem_bin(path):
    """Load a snapshot written by `write_problem_bin`.
    Returns (data, cone, settings) like io.read_problem."""
    import struct  # noqa: PLC0415

    from scipy import sparse  # noqa: PLC0415

    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    m = np.zeros(1, np.int64)
    n = np.zeros(1, np.int64)
    has_p = np.zeros(1, np.int64)
    a_nnz = np.zeros(1, np.int64)
    p_nnz = np.zeros(1, np.int64)
    rc = lib.read_problem_header(
        str(path).encode(), _ptr(m, _i64p), _ptr(n, _i64p),
        _ptr(has_p, _i64p), _ptr(a_nnz, _i64p), _ptr(p_nnz, _i64p))
    if rc != 0:
        raise IOError(f"read_problem_header failed with code {rc}")
    m, n, hp, an, pn = (int(m[0]), int(n[0]), int(has_p[0]), int(a_nnz[0]),
                        int(p_nnz[0]))
    b = np.empty(m, np.float64)
    c = np.empty(n, np.float64)
    a_ip = np.empty(n + 1, np.int64)
    a_ix = np.empty(max(an, 1), np.int64)
    a_dat = np.empty(max(an, 1), np.float64)
    p_ip = np.empty(n + 1, np.int64)
    p_ix = np.empty(max(pn, 1), np.int64)
    p_dat = np.empty(max(pn, 1), np.float64)
    tail = np.zeros(1 << 20, np.uint8)
    tail_len = np.zeros(1, np.int64)
    rc = lib.read_problem_body(
        str(path).encode(), m, n, hp, an, pn,
        _ptr(b, _f64p), _ptr(c, _f64p), _ptr(a_ip, _i64p), _ptr(a_ix, _i64p),
        _ptr(a_dat, _f64p), _ptr(p_ip, _i64p), _ptr(p_ix, _i64p),
        _ptr(p_dat, _f64p), _ptr(tail, _u8p), tail.size,
        _ptr(tail_len, _i64p))
    if rc != 0:
        raise IOError(f"read_problem_body failed with code {rc}")

    data = {
        "b": b,
        "c": c,
        "A": sparse.csc_matrix((a_dat[:an], a_ix[:an], a_ip), shape=(m, n)),
    }
    if hp:
        data["P"] = sparse.csc_matrix(
            (p_dat[:pn], p_ix[:pn], p_ip), shape=(n, n))

    buf = tail.tobytes()[: int(tail_len[0])]
    off = 0

    def rd_i64():
        nonlocal off
        (v,) = struct.unpack_from("<q", buf, off)
        off += 8
        return v

    settings = {}
    for _ in range(rd_i64()):
        ln = rd_i64()
        name = buf[off : off + ln].decode()
        off += ln
        (val,) = struct.unpack_from("<d", buf, off)
        off += 8
        settings[name] = int(val) if float(val).is_integer() else val
    cone = {}
    for _ in range(rd_i64()):
        ln = rd_i64()
        name = buf[off : off + ln].decode()
        off += ln
        alen = rd_i64()
        arr = np.frombuffer(buf, np.float64, alen, off).copy()
        off += 8 * alen
        if name in ("p", "bl", "bu"):
            cone[name] = arr.tolist() if alen != 1 else float(arr[0])
        elif alen == 1:
            cone[name] = int(arr[0])
        else:
            cone[name] = [int(v) for v in arr]
    return data, cone, settings


try:  # eager probe so `native.available` is meaningful at import time
    _load()
except Exception:
    available = False
