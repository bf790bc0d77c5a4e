"""ctypes bindings for the native IQ transport (+ numpy fallback).

Build on first import (cc -O3 -shared); if no compiler or the build fails,
pure-numpy equivalents keep everything working. ``HAVE_NATIVE`` reports
which path is active.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "iqtransport.c")
_SO = os.path.join(_DIR, "_iqtransport.so")

_lib = None


def _build() -> bool:
    for cc in ("cc", "gcc", "clang"):
        try:
            r = subprocess.run(
                [cc, "-O3", "-march=native", "-shared", "-fPIC", "-o", _SO, _SRC],
                capture_output=True, timeout=120)
            if r.returncode == 0:
                return True
        except (FileNotFoundError, subprocess.TimeoutExpired):
            continue
    return False


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    lib.iq_i16_to_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_float]
    lib.iq_f32_to_i16.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_float]
    lib.iq_i16_deinterleave.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_void_p, ctypes.c_int64]
    lib.rb_create.restype = ctypes.c_void_p
    lib.rb_create.argtypes = [ctypes.c_uint64]
    lib.rb_destroy.argtypes = [ctypes.c_void_p]
    lib.rb_capacity.restype = ctypes.c_uint64
    lib.rb_capacity.argtypes = [ctypes.c_void_p]
    lib.rb_fill.restype = ctypes.c_uint64
    lib.rb_fill.argtypes = [ctypes.c_void_p]
    lib.rb_write.restype = ctypes.c_uint64
    lib.rb_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64]
    lib.rb_read.restype = ctypes.c_uint64
    lib.rb_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64]
    _lib = lib
    return lib


HAVE_NATIVE = _load() is not None


def iq_i16_to_c64(pcm: np.ndarray, scale: float = 1.0 / 32767.0) -> np.ndarray:
    """Interleaved int16 I/Q -> complex64 (the capture-ingest hot loop)."""
    pcm = np.ascontiguousarray(pcm, dtype=np.int16)
    assert pcm.size % 2 == 0
    out = np.empty(pcm.size, dtype=np.float32)
    lib = _load()
    if lib is not None:
        lib.iq_i16_to_f32(pcm.ctypes.data, out.ctypes.data, pcm.size, np.float32(scale))
    else:
        np.multiply(pcm, scale, out=out, casting="unsafe")
    return out.view(np.complex64)


def c64_to_iq_i16(iq: np.ndarray, scale: float = 32767.0) -> np.ndarray:
    """complex64 -> interleaved int16 I/Q with saturation (DAC direction)."""
    iq = np.ascontiguousarray(iq, dtype=np.complex64)
    flat = iq.view(np.float32)
    out = np.empty(flat.size, dtype=np.int16)
    lib = _load()
    if lib is not None:
        lib.iq_f32_to_i16(flat.ctypes.data, out.ctypes.data, flat.size, np.float32(scale))
    else:
        np.clip(flat * scale, -32768, 32767, out := np.empty(flat.size, np.float32))
        out = out.astype(np.int16)
    return out


def iq_i16_deinterleave(pcm: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Interleaved int16 I/Q -> (xr, xi) int16 planes — the int16-ingest
    fast path (cfg.int16_ingest): the device upcasts, so the host never
    converts to f32 and moves half the bytes."""
    pcm = np.ascontiguousarray(pcm, dtype=np.int16)
    assert pcm.size % 2 == 0
    n = pcm.size // 2
    xr = np.empty(n, dtype=np.int16)
    xi = np.empty(n, dtype=np.int16)
    lib = _load()
    if lib is not None:
        lib.iq_i16_deinterleave(pcm.ctypes.data, xr.ctypes.data, xi.ctypes.data, n)
    else:
        xr[:] = pcm[0::2]
        xi[:] = pcm[1::2]
    return xr, xi


class RingBuffer:
    """Lock-free SPSC ring buffer over the native impl (numpy fallback)."""

    def __init__(self, capacity_bytes: int):
        lib = _load()
        self._lib = lib
        if lib is not None:
            self._h = lib.rb_create(capacity_bytes)
            assert self._h, "rb_create failed"
            self.capacity = lib.rb_capacity(self._h)
        else:
            cap = 1
            while cap < capacity_bytes:
                cap <<= 1
            self.capacity = cap
            self._buf = bytearray()

    def write(self, arr: np.ndarray) -> bool:
        data = np.ascontiguousarray(arr)
        n = data.nbytes
        if self._lib is not None:
            return bool(self._lib.rb_write(self._h, data.ctypes.data, n))
        if len(self._buf) + n > self.capacity:
            return False
        self._buf.extend(data.tobytes())
        return True

    def read(self, n_bytes: int, dtype=np.complex64) -> np.ndarray | None:
        out = np.empty(n_bytes // np.dtype(dtype).itemsize, dtype=dtype)
        if self._lib is not None:
            got = self._lib.rb_read(self._h, out.ctypes.data, n_bytes)
            return out if got else None
        if len(self._buf) < n_bytes:
            return None
        out = np.frombuffer(bytes(self._buf[:n_bytes]), dtype=dtype).copy()
        del self._buf[:n_bytes]
        return out

    @property
    def fill(self) -> int:
        if self._lib is not None:
            return int(self._lib.rb_fill(self._h))
        return len(self._buf)

    def __del__(self):
        if getattr(self, "_lib", None) is not None and getattr(self, "_h", None):
            self._lib.rb_destroy(self._h)
