"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` to an object, one process per source,
all started together, and links them into one shared library with a plain
C interface, which is loaded with ``ctypes``.  The build runs at first use,
never at import, so the package imports on machines without ``nvcc`` or a
GPU.  The library lands in ``build/iisan_tpu_torch/<hash>/`` at the root of
the checkout; the hash covers the sources and the compiler flags, so an
edited source builds anew and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "iisan_tpu_torch"
NVCC_FLAGS = ("-O3", "-std=c++17", "-Xcompiler", "-fPIC",
              "-gencode", "arch=compute_90a,code=sm_90a", "-Xptxas=-v")
LIB_NAME = "libiisan_kernels.so"

_lock = threading.Lock()
_lib = None


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    """Hash of the kernel sources and the nvcc flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cu, cuh = _sources()
    for path in cu + cuh:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = Path(cuda_home) / "bin" / "nvcc"
    if nvcc.is_file():
        return str(nvcc)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                           "the CUDA kernels cannot be built")
    return found


def build() -> Path:
    """Compile the library unless this hash is built; returns its path.

    The ptxas report (registers, shared memory, spills per kernel) is kept
    in ``build.log`` beside the library.  A failed build raises with
    nvcc's output.
    """
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    nvcc, tag = nvcc_path(), os.getpid()
    t0 = time.perf_counter()
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in cu]
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                         for src, obj in zip(cu, objs))]
    report = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        report.append(f"{' '.join(cmd)}\n{out}")
        if proc.returncode != 0:
            for _, other in procs:
                other.kill()
                other.wait()
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{out}")
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    for obj in objs:
        obj.unlink()
    (out_dir / "build.log").write_text(
        "".join(report) + f"{' '.join(cmd)}\n"
        f"{time.perf_counter() - t0:.1f} s\n")
    os.replace(tmp, lib)
    return lib


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    u = ctypes.c_uint
    lib.iisan_user_encoder_weights.argtypes = [p, p, ll] + [i] * 4 + [p]
    lib.iisan_user_encoder_weights.restype = i
    lib.iisan_user_encoder_fwd.argtypes = [p] * 6 + [ll] + [i] * 9 + [f, f, p]
    lib.iisan_user_encoder_fwd.restype = i
    lib.iisan_user_encoder_bwd.argtypes = [p] * 7 + [ll, p] + [i] * 8 + [f, f, i, p]
    lib.iisan_user_encoder_bwd.restype = i
    lib.iisan_user_encoder_bwd_tc.argtypes = [p] * 7 + [ll] + [i] * 8 + [f, f, p]
    lib.iisan_user_encoder_bwd_tc.restype = i
    lib.iisan_user_encoder_wgrad.argtypes = [p, ll, p] + [i] * 7 + [p]
    lib.iisan_user_encoder_wgrad.restype = i
    lib.iisan_user_encoder_tc_layout.argtypes = [i] * 7 + [p, i]
    lib.iisan_user_encoder_tc_layout.restype = i
    lib.iisan_philox_check.argtypes = [i] * 4 + [p] * 3
    lib.iisan_philox_check.restype = i
    lib.iisan_san_cascade_fwd.argtypes = [p] * 9 + [i] * 12 + [p]
    lib.iisan_san_cascade_fwd.restype = i
    lib.iisan_san_cascade_streamed_fwd.argtypes = [p] * 10 + [i] * 10 + [p]
    lib.iisan_san_cascade_streamed_fwd.restype = i
    lib.iisan_mha_fwd.argtypes = [p] * 5 + [i] * 6 + [f, f, i, p]
    lib.iisan_mha_fwd.restype = i
    lib.iisan_mha_bwd.argtypes = [p] * 9 + [i] * 6 + [f, f, i, p]
    lib.iisan_mha_bwd.restype = i
    lib.iisan_mha_bwd_design.argtypes = [i, i]
    lib.iisan_mha_bwd_design.restype = i
    lib.iisan_mha_bwd_stats_tail.argtypes = []
    lib.iisan_mha_bwd_stats_tail.restype = i
    lib.iisan_mha_bwd_active_clusters.argtypes = [i, i, p]
    lib.iisan_mha_bwd_active_clusters.restype = i
    lib.iisan_mha_mask_replay.argtypes = [p] + [i] * 4 + [u, f, u, p]
    lib.iisan_mha_mask_replay.restype = i
    lib.iisan_w8a8_quant_rows.argtypes = [p] * 3 + [i] * 3 + [p]
    lib.iisan_w8a8_quant_rows.restype = i
    lib.iisan_w8a8_gemm.argtypes = [p] * 6 + [i] * 5 + [p]
    lib.iisan_w8a8_gemm.restype = i
    lib.iisan_attn_subblock_fwd.argtypes = [p] * 9 + [i] * 5 + [f, f, i, p]
    lib.iisan_attn_subblock_fwd.restype = i
    lib.iisan_attn_subblock_v2_fwd.argtypes = [p] * 9 + [i] * 6 + [f, f, i, p]
    lib.iisan_attn_subblock_v2_fwd.restype = i
    lib.iisan_subblock_qkv_gemm.argtypes = [p] * 4 + [i] * 2 + [p]
    lib.iisan_subblock_qkv_gemm.restype = i
    lib.iisan_cuda_error_string.argtypes = [i]
    lib.iisan_cuda_error_string.restype = ctypes.c_char_p


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
    return _lib


def sass_mma_counts(pattern: str) -> dict:
    """Tensor-core instructions in the SASS of each kernel of the built
    library whose name holds ``pattern`` (``cuobjdump -sass``), by opcode:
    ``{kernel: {"HGMMA": n, "HMMA": m}}`` (wgmma and mma.sync)."""
    cuobjdump = Path(nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(build())], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            name = line.split(":", 1)[1].strip()
            if pattern in name:
                counts[name] = {"HGMMA": 0, "HMMA": 0}
        elif name in counts:
            for op in ("HGMMA", "HMMA"):  # neither name holds the other
                counts[name][op] += op in line
    return counts


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err != 0:
        msg = library().iisan_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
