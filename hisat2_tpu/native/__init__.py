"""Native (C++) host components, loaded via ctypes.

The compute path is JAX/XLA on the device; host-side throughput pieces
mirror the reference's C++ roles (blockwise_sa.h suffix sorting, pat.h
parsing).  Sources live in native/ at the repo root; they compile at first
use into native/build/ (not committed; keyed by the host CPU, since they are
built with -march=native) — no pip/pybind dependency, plain g++ + ctypes.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC_DIR = os.path.join(_REPO, "native")
_BUILD_DIR = os.path.join(_SRC_DIR, "build")

_libs = {}


def _host_tag() -> str:
    """Short hash of this CPU's feature flags: -march=native objects are
    keyed by it, so a library built on one host is never loaded on
    another."""
    import hashlib
    import platform
    flags = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    flags += line
                    break
    except OSError:
        pass
    return hashlib.sha1(flags.encode()).hexdigest()[:10]


def _build(name: str, srcs) -> str:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    so = os.path.join(_BUILD_DIR, f"lib{name}-{_host_tag()}.so")
    stale = not os.path.exists(so) or any(
        os.path.getmtime(os.path.join(_SRC_DIR, s)) > os.path.getmtime(so)
        for s in srcs)
    if stale:
        # build to a private name, then rename: concurrent first users
        # (test workers, multi-process runs) never load a partial file
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
               "-std=c++17", "-o", tmp]
        cmd += [os.path.join(_SRC_DIR, s) for s in srcs]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so)
    return so


def get_sais():
    """ctypes handle to the SA-IS suffix-array builder (native/sais.cpp),
    or None if no C++ toolchain is available."""
    if "sais" in _libs:
        return _libs["sais"]
    try:
        lib = ctypes.CDLL(_build("sais", ["sais.cpp"]))
    except (OSError, subprocess.CalledProcessError) as e:
        print(f"[native] sais unavailable ({e}); falling back to numpy",
              file=sys.stderr)
        _libs["sais"] = None
        return None
    lib.sais_int32.restype = ctypes.c_int
    lib.sais_int32.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int64, ctypes.c_int32]
    lib.sais_int64.restype = ctypes.c_int
    lib.sais_int64.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int64, ctypes.c_int32]
    _libs["sais"] = lib
    return lib


def get_samfmt():
    """ctypes handle to the batch SAM line formatter (native/samfmt.c),
    or None when no toolchain is available (the Python writer loop is the
    fallback and stays byte-identical)."""
    if "samfmt" in _libs:
        return _libs["samfmt"]
    try:
        lib = ctypes.CDLL(_build("samfmt", ["samfmt.c"]))
    except (OSError, subprocess.CalledProcessError) as e:
        print(f"[native] samfmt unavailable ({e}); SAM output falls back "
              f"to the slower Python writer loop", file=sys.stderr)
        _libs["samfmt"] = None
        return None
    lib.sam_render_batch.restype = ctypes.c_int
    lib.sam_render_batch.argtypes = [ctypes.c_int64] * 3 \
        + [ctypes.c_void_p] * 23 + [ctypes.c_int8] \
        + [ctypes.c_void_p] * 2
    _libs["samfmt"] = lib
    return lib


def suffix_array_native(text_codes):
    """SA of text (uint8 codes 0..3) + implicit sentinel, via SA-IS.
    Returns int32 (or int64 for huge texts) array of length n+1, or None
    when the native library is unavailable."""
    import numpy as np
    lib = get_sais()
    if lib is None:
        return None
    n = len(text_codes) + 1
    t = np.empty(n, np.int32)
    t[:-1] = text_codes.astype(np.int32) + 1
    t[-1] = 0
    if n <= 2 ** 31 - 1:
        sa = np.empty(n, np.int32)
        rc = lib.sais_int32(t.ctypes.data, sa.ctypes.data, n, 5)
    else:
        sa = np.empty(n, np.int64)
        rc = lib.sais_int64(t.ctypes.data, sa.ctypes.data, n, 5)
    if rc != 0:
        return None
    return sa
