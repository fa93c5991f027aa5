"""ctypes binding to the JPEG decode + resize library (``csrc/fastimage.cc``).

Port of ``iisan_tpu/data/fastimage.py``.  The library is the port's own
build of ``csrc/fastimage.cc``: ``g++ ... -ljpeg`` at first use (never at
import) into ``build/iisan_tpu_torch/fastimage-<hash>/`` at the root of the
checkout, the hash covering the source and the flags.  Where ``g++`` or
libjpeg (``jpeglib.h`` and ``libjpeg.so``) is missing, ``library()``
raises ``DecoderUnavailable`` naming what is missing: the JPEG paths of
``data/images.py`` never substitute another decoder or synthetic images.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from ..kernels.build import BUILD_ROOT

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "fastimage.cc")
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-ljpeg", "-lpthread")
LIB_NAME = "libfastimage.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class DecoderUnavailable(RuntimeError):
    """The JPEG decoder cannot be built here (no g++ or no libjpeg)."""


def _out_dir() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(str(BUILD_ROOT), f"fastimage-{h.hexdigest()[:16]}")


def build() -> str:
    """Compile the library unless this hash is built; returns its path."""
    out_dir = _out_dir()
    lib = os.path.join(out_dir, LIB_NAME)
    if os.path.isfile(lib):
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise DecoderUnavailable(
            f"the JPEG decoder {SOURCE} needs g++, which is not on PATH")
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [cxx, *CXX_FLAGS, "-o", tmp, SOURCE, *LIBS]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise DecoderUnavailable(
            f"the JPEG decoder {SOURCE} did not build: it needs libjpeg "
            f"(jpeglib.h and libjpeg.so) beside g++.\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded decoder, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:  # built where libjpeg was, loaded where not
                raise DecoderUnavailable(
                    f"the JPEG decoder {path} does not load: {e} (it needs "
                    "libjpeg's shared library)") from e
            lib.fastimage_decode_resize_batch.restype = ctypes.c_int
            lib.fastimage_decode_resize_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_size_t),
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8),
            ]
            lib.fastimage_abi_version.restype = ctypes.c_int
            lib.fastimage_abi_version.argtypes = []
            if lib.fastimage_abi_version() != 1:
                raise DecoderUnavailable(f"{path}: unexpected ABI version")
            _lib = lib
    return _lib


def decode_resize(jpeg_blob: bytes, resize: int) -> Tuple[np.ndarray, bool]:
    """Decode one JPEG byte string to a (resize, resize, 3) uint8 image;
    returns it and whether libjpeg decoded it (an undecodable blob comes
    back as zeros)."""
    lib = library()
    out = np.empty((1, resize, resize, 3), dtype=np.uint8)
    datas = (ctypes.c_char_p * 1)(jpeg_blob)  # borrowed: the blob outlives the call
    lens = (ctypes.c_size_t * 1)(len(jpeg_blob))
    ok = lib.fastimage_decode_resize_batch(
        datas, lens, 1, resize, 1,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out[0], ok == 1
