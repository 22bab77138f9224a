"""Build the port's CUDA kernels with nvcc and load them through ctypes.

The sources under ``aero_tpu_torch/csrc`` have a plain C interface, so they
compile without PyTorch's headers: one nvcc process per ``.cu`` file, all
started together, then one link into a shared library. The build runs at
first use, never at import, and is keyed by a hash of the sources and
flags; the library lands in ``build/aero_tpu_torch/`` at the repository
root, which git ignores.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "aero_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lib = None
build_log = ""  # nvcc/ptxas output of the build this process ran


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return found


def library_path() -> Path:
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libaero_tpu_torch_{digest.hexdigest()[:16]}.so"


def _build(path: Path) -> str:
    """Compile every source in parallel, link ``path``; returns the log."""
    nvcc = _nvcc()
    tag = f"{path.stem}.{os.getpid()}"
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    tmp = path.with_name(f"{tag}.tmp")
    try:
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "".join(log))
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                              *map(str, objs)], capture_output=True, text=True)
        log.append(res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               + "".join(log))
        os.replace(tmp, path)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return "".join(log)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        build_log = _build(path)
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.aero_local_attention_fwd.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
    lib.aero_local_attention_fwd.restype = i32
    lib.aero_local_attention_bwd.argtypes = [ptr] * 12 + [i32] * 4 + [ptr]
    lib.aero_local_attention_bwd.restype = i32
    lib.aero_cuda_error_string.argtypes = [i32]
    lib.aero_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib
