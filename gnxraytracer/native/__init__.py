"""Native runtime library (C++ via ctypes): SAH BVH builder + Halton
permutation generator.

Built on first use from the tracked source into native/build/ (git-
ignored), under a name keyed on a hash of the source, so a checkout never
loads a binary built from other source.  Without a C++ compiler every
consumer falls back to numpy; that costs host build time and is logged
once.
"""

import ctypes
import hashlib
import logging
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(__file__)
_SRC = os.path.join(_HERE, "bvh_builder.cpp")
_BUILD = os.path.join(_HERE, "build")
_lib = None
_unavailable = False

log = logging.getLogger(__name__)


def _so_path():
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD, f"libgnx_native-{digest}.so")


def _compile(so):
    os.makedirs(_BUILD, exist_ok=True)
    # build beside the target and rename: concurrent test workers may race
    tmp = f"{so}.{os.getpid()}.tmp"
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                   check=True, capture_output=True)
    os.replace(tmp, so)


def get_lib():
    """The loaded library, or None when no C++ compiler is installed."""
    global _lib, _unavailable
    if _lib is not None or _unavailable:
        return _lib
    so = _so_path()
    if not os.path.exists(so):
        try:
            _compile(so)
        except FileNotFoundError:
            _unavailable = True
            log.warning("g++ not found: native BVH builder and Halton tables "
                        "fall back to numpy")
            return None
    lib = ctypes.CDLL(so)
    lib.gnx_build_bvh_sah.restype = ctypes.c_int
    lib.gnx_halton_permutations.restype = None
    _lib = lib
    return lib


class bvh_native:
    """Namespace used by ops/bvh.py: build(verts, tris, leaf_size)."""

    @staticmethod
    def build(verts, tris, leaf_size):
        """SAH build arrays, or None when the library is unavailable or
        the tree would overflow its node budget."""
        lib = get_lib()
        if lib is None:
            return None
        verts = np.ascontiguousarray(verts, np.float32)
        tris = np.ascontiguousarray(tris, np.int32)
        n_tris = len(tris)
        max_nodes = max(2 * n_tris, 8)
        lo = np.empty((max_nodes, 3), np.float32)
        hi = np.empty((max_nodes, 3), np.float32)
        off = np.empty(max_nodes, np.int32)
        npr = np.empty(max_nodes, np.int32)
        ax = np.empty(max_nodes, np.int32)
        order = np.empty(n_tris + leaf_size, np.int32)
        order_len = ctypes.c_int(0)
        c = lambda a: a.ctypes.data_as(ctypes.c_void_p)
        n_nodes = lib.gnx_build_bvh_sah(
            c(verts), len(verts), c(tris), n_tris, leaf_size,
            c(lo), c(hi), c(off), c(npr), c(ax), c(order), max_nodes,
            ctypes.byref(order_len),
        )
        if n_nodes < 0:
            return None
        ol = order_len.value
        return (lo[:n_nodes].copy(), hi[:n_nodes].copy(), off[:n_nodes].copy(),
                npr[:n_nodes].copy(), ax[:n_nodes].copy(), order[:ol].copy())


def halton_permutations(primes):
    """Bit-exact reference permutation table, generated natively; None
    when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    primes = np.ascontiguousarray(primes, np.int32)
    out = np.empty(int(primes.sum()), np.int32)
    lib.gnx_halton_permutations(
        primes.ctypes.data_as(ctypes.c_void_p), len(primes),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out
