"""ctypes binding to the JPEG decode + resize library (``csrc/fastimage.cc``).

Port of ``iisan_tpu/data/fastimage.py``.  The library is the port's own
build of ``csrc/fastimage.cc`` with ``g++`` at first use (never at import)
into ``build/iisan_tpu_torch/fastimage-<hash>/`` at the root of the
checkout, the hash covering the source, the flags and the libjpeg linked.
It links the first libjpeg of these that builds (``routes``):

1. the libjpeg that Pillow's wheel bundles (``pillow.libs/libjpeg-*.so*``
   beside ``PIL``), compiled against the libjpeg-turbo API-62 headers in
   ``csrc/jpeg/`` and found at run time through an rpath;
2. the system's (``jpeglib.h`` and ``-ljpeg``).

``route()`` names the one loaded.  Where neither builds, ``library()``
raises ``DecoderUnavailable`` naming what is missing, and
``data/images.DirImageStore`` decodes with Pillow, as the JAX package's
store does without its native library.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import importlib.util
import os
import shutil
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

from ..kernels.build import BUILD_ROOT

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
SOURCE = os.path.join(CSRC, "fastimage.cc")
HEADERS = os.path.join(CSRC, "jpeg")  # libjpeg-turbo's API-62 headers
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
LIB_NAME = "libfastimage.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_route: Optional[str] = None


class DecoderUnavailable(RuntimeError):
    """The JPEG decoder cannot be built here (no g++ or no libjpeg)."""


def pillow_libjpeg() -> Optional[str]:
    """The libjpeg shared library that Pillow's wheel bundles
    (``pillow.libs/libjpeg-*.so*`` beside the ``PIL`` package), or None.
    Pillow is located, not imported."""
    spec = importlib.util.find_spec("PIL")
    if spec is None or not spec.origin:
        return None
    libs = os.path.join(os.path.dirname(os.path.dirname(spec.origin)),
                        "pillow.libs")
    found = sorted(glob.glob(os.path.join(libs, "libjpeg*.so*")))
    return found[0] if found else None


def routes() -> List[Tuple[str, Tuple[str, ...]]]:
    """(name, compiler arguments after the source) of each libjpeg to link,
    in the order tried."""
    out = []
    bundled = pillow_libjpeg()
    if bundled is not None:
        out.append((f"Pillow's bundled libjpeg ({os.path.basename(bundled)})",
                    ("-I", HEADERS, bundled,
                     f"-Wl,-rpath,{os.path.dirname(bundled)}", "-lpthread")))
    out.append(("the system libjpeg (-ljpeg)", ("-ljpeg", "-lpthread")))
    return out


def _out_dir(args: Tuple[str, ...]) -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS + args).encode())
    for path in [SOURCE] + sorted(glob.glob(os.path.join(HEADERS, "*.h"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(str(BUILD_ROOT), f"fastimage-{h.hexdigest()[:16]}")


def build(names=None) -> Tuple[str, str]:
    """Compile the library against the first libjpeg of ``routes()`` (of
    those named in ``names``, default all) that builds, unless its hash is
    built; returns (its path, the route's name)."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise DecoderUnavailable(
            f"the JPEG decoder {SOURCE} needs g++, which is not on PATH")
    errors = []
    for name, args in routes():
        if names is not None and name not in names:
            continue
        out_dir = _out_dir(args)
        lib = os.path.join(out_dir, LIB_NAME)
        if os.path.isfile(lib):
            return lib, name
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [cxx, *CXX_FLAGS, "-o", tmp, SOURCE, *args]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode == 0:
            os.replace(tmp, lib)
            return lib, name
        errors.append(f"{name}: {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    raise DecoderUnavailable(
        f"the JPEG decoder {SOURCE} did not build: it needs libjpeg (Pillow's "
        "bundled libjpeg, or jpeglib.h and libjpeg.so) beside g++.\n"
        + "\n".join(errors))


def route() -> str:
    """The name of the libjpeg the loaded decoder links (builds it)."""
    library()
    return _route


def load(path: str) -> ctypes.CDLL:
    """The library at ``path`` (a ``build()`` output), its functions
    declared."""
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
    return lib


def library() -> ctypes.CDLL:
    """The loaded decoder, built on first use."""
    global _lib, _route
    with _lock:
        if _lib is None:
            path, name = build()
            _lib, _route = load(path), name
    return _lib


def decode_resize(jpeg_blob: bytes, resize: int,
                  lib: Optional[ctypes.CDLL] = None) -> Tuple[np.ndarray, bool]:
    """Decode one JPEG byte string to a (resize, resize, 3) uint8 image
    through ``lib`` (default ``library()``); returns it and whether libjpeg
    decoded it (an undecodable blob comes back as zeros)."""
    lib = lib or library()
    out = np.empty((1, resize, resize, 3), dtype=np.uint8)
    datas = (ctypes.c_char_p * 1)(jpeg_blob)  # borrowed: the blob outlives the call
    lens = (ctypes.c_size_t * 1)(len(jpeg_blob))
    ok = lib.fastimage_decode_resize_batch(
        datas, lens, 1, resize, 1,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out[0], ok == 1
