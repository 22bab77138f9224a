"""ctypes binding of the native IO library ``native/lib/libaeroio.so``
(copy of ``aero_tpu/data/native_io.py``).

The data pipeline reads WAV segments through it when it loads, and falls
back to the numpy codec otherwise. The library decodes without holding the
GIL, so loader worker threads scale. It is opened at first use, never at
import. ``AERO_NATIVE_LIB`` names another copy of the library.
"""

from __future__ import annotations

import ctypes
import os
import typing as tp

import numpy as np

_LIB = None
_TRIED = False


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def get_lib():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = os.environ.get(
        "AERO_NATIVE_LIB",
        os.path.join(_repo_root(), "native", "lib", "libaeroio.so"))
    if os.path.exists(path):
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.aeroio_info.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong)]
        lib.aeroio_info.restype = ctypes.c_int
        lib.aeroio_read.argtypes = [
            ctypes.c_char_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_longlong)]
        lib.aeroio_read.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def available() -> bool:
    return get_lib() is not None


def info(path: str) -> tp.Tuple[int, int, int]:
    """(sample_rate, channels, num_frames)."""
    sr, ch, frames = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    if get_lib().aeroio_info(path.encode(), ctypes.byref(sr),
                             ctypes.byref(ch), ctypes.byref(frames)) != 0:
        raise IOError(f"aeroio: cannot read {path}")
    return sr.value, ch.value, frames.value


def load(path: str, frame_offset: int = 0,
         num_frames: int = -1) -> tp.Tuple[np.ndarray, int]:
    """([channels, frames] float32, sample_rate). A read that reaches the
    end of the file is truncated to the frames read, as ``audio_io.load``;
    callers that need fixed-length segments pad them."""
    sr, ch, total = info(path)
    if num_frames is None or num_frames < 0:
        num_frames = max(0, total - frame_offset)
    out = np.zeros((ch, num_frames), np.float32)
    got = ctypes.c_longlong()
    rc = get_lib().aeroio_read(
        path.encode(), frame_offset, num_frames,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(got))
    if rc != 0:
        raise IOError(f"aeroio: read failed for {path}")
    return out[:, :got.value], sr
