"""Build the port's CUDA kernels with nvcc and bind them through ctypes.

Every ``csrc/*.cu`` file is compiled for ``sm_90a`` at first use, one
``nvcc`` per source, all started together, and the objects are linked
into one shared library with a plain C interface in
``build/ksw2_tpu_torch/`` beside the package.  The library's file name
carries a hash of the sources and flags, so an edited source rebuilds,
and a file lock serialises concurrent first uses.  Only the sources in
this package are compiled.

``LAUNCHES`` counts kernel launches by name: each wrapper adds one where
it launches its kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from collections import Counter
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "ksw2_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: Counter = Counter()

_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # qs, ts, qlen, tlen, table, don, acc, B, Lq, tv, m, q, e, q2, e2, lt,
    # ld, mat0, kb, right, cig, two, spl, threads, D, Dq, hl, d8, stream
    "ksw2t_strips_fwd": [_P] * 7 + [_I] * 17 + [_P] * 5,
    # qs, ts, qlen, tlen, table, B, Lq, tv, m, q, e, mat0, kb, D, Dq, hl,
    # stream
    "ksw2t_rows_fwd": [_P] * 5 + [_I] * 8 + [_P] * 4,
    # d8, starts, B, tv, Lq, wr, min_intron, res, runs, stream
    "ksw2t_strips_walk": [_P, _P] + [_I] * 5 + [_P] * 3,
    # qs, ts, qlen, tlen, w, table, B, Lq, Lt, m, q, e, q2, e2, qe_pre, lt,
    # ld, sc_mch, sc_mis, sc_N, zdrop, right, generic, approx, adrop, cig,
    # two, nd, ncol, RB, threads, rec, p, stream
    "ksw2t_band_fwd": [_P] * 6 + [_I] * 25 + [_P] * 3,
    # p, starts, qlen, tlen, w, B, nd, ncol, wr, min_intron, res, runs,
    # stream
    "ksw2t_band_walk": [_P] * 5 + [_I] * 5 + [_P] * 3,
    # qs, ts, qlen, tlen, w, table, B, Lq, Lt, m, q, e, q2, e2, qe_pre, lt,
    # ld, sc_mch, sc_mis, sc_N, zdrop, right, generic, approx, adrop, cig,
    # two, nd, ncol, TP, warps, rec, p, stream
    "ksw2t_batch_fwd": [_P] * 6 + [_I] * 25 + [_P] * 3,
    # qs, ts, qlen, tlen, table, don, acc, B, Lq, Lt, m, q, e, q2, lt, ld,
    # sc_mch, sc_mis, sc_N, zdrop, right, generic, approx, adrop, cig, nd,
    # ncol, TP, warps, rec, p, stream
    "ksw2t_batch_exts_fwd": [_P] * 7 + [_I] * 22 + [_P] * 3,
    # mode, qs, ts, qlen, tlen, w, table, don, acc, tbase, dbase, bbase,
    # pbase, B, Lq, Lt, m, q, e, q2, e2, qe_pre, lt, ld, sc_mch, sc_mis,
    # sc_N, zdrop, right, generic, approx, adrop, cig, TP, n_tiles, ticket,
    # progress, bnd, D, hse, W, rec, stop, p, stream
    "ksw2t_extz_fwd": [_I] + [_P] * 12 + [_I] * 22 + [_P] * 10,
    # p, pbase, starts, qlen, tlen, w, B, wr, min_intron, upper_force, res,
    # runs, stream
    "ksw2t_extz_walk": [_P] * 6 + [_I] * 4 + [_P] * 3,
    # p, pbase, starts, qlen, tlen, w, B, wr, res, runs, stream
    "ksw2t_flat_walk": [_P] * 6 + [_I] * 2 + [_P] * 3,
    # qs, ts, qlen, tlen, w, B, Lq, Lt, mch, mis, e, xdrop, TP, warps, rec,
    # stream
    "ksw2t_batch_extf_fwd": [_P] * 5 + [_I] * 9 + [_P] * 2,
    # qs, ts, qlen, tlen, w, B, Lq, Lt, mch, mis, e, xdrop, TP, warps,
    # scratch, rec, stream
    "ksw2t_extf_fwd": [_P] * 5 + [_I] * 9 + [_P] * 3,
    # qs, ts, qlen, tlen, w, table, pbase, B, Lq, Lt, m, q, e, TP, warps,
    # score, p, stream
    "ksw2t_batch_gg2_fwd": [_P] * 7 + [_I] * 8 + [_P] * 3,
    # qs, ts, qlen, tlen, w, table, pbase, B, Lq, Lt, m, q, e, blk, warps,
    # scratch, score, p, stream
    "ksw2t_gg2_fwd": [_P] * 7 + [_I] * 6 + [ctypes.c_longlong, _I]
    + [_P] * 4,
}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the port's kernels need the CUDA "
                       "toolkit on the machine with the card")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libksw2t_{h.hexdigest()[:16]}.so"


def _compile_and_link(out: Path) -> None:
    """One ``nvcc -c`` per source, all running at once, then one link
    into ``out``; the compilers' reports go to ``<out>.log``."""
    nvcc = _nvcc()
    tag = f"{out.stem}.tmp{os.getpid()}"
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in srcs]
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(s), "-o", str(o)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for s, o in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]
    tmp = BUILD_DIR / f"{tag}.so"
    try:
        failed = [f"{s.name} ({p.returncode}):\n{log}" for s, p, log
                  in zip(srcs, procs, logs) if p.returncode != 0]
        if not failed:
            link = subprocess.run(
                [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                 *map(str, objs)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            logs.append(link.stdout)
            if link.returncode != 0:
                failed.append(f"link ({link.returncode}):\n{link.stdout}")
        out.with_suffix(".log").write_text("".join(logs))
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        os.replace(tmp, out)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
        tmp.unlink(missing_ok=True)


def build() -> Path:
    """Compile the kernels unless a library of these sources exists;
    returns its path.  The compiler's resource report (``-Xptxas -v``)
    is kept beside it as ``<name>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if out.exists():
                return out
            _compile_and_link(out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.ksw2t_error_string.argtypes = [ctypes.c_int]
        lib.ksw2t_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise when a C entry point returned a CUDA error."""
    if err != 0:
        msg = library().ksw2t_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


__all__ = ["LAUNCHES", "BUILD_DIR", "build", "library", "library_path",
           "check"]
