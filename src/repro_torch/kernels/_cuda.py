"""Build, load and launch-count the hand-written Hopper kernels.

The CUDA C++ sources in ``repro_torch/csrc/*.cu`` expose a plain C
interface.  At first use :func:`lib` compiles each source with ``nvcc`` for
``sm_90a`` (one process per source, all started together), links the objects
into one shared library under the repository's ``build/`` directory, and
loads it with ``ctypes``.  The library's name carries a hash of the sources
and flags, so an edited source is rebuilt and a stale library is never
loaded.

Every C launcher enqueues its kernel on the stream it is given, allocates
nothing, and returns ``cudaGetLastError()``; :func:`check` raises on a
non-zero code.  :data:`LAUNCHES` counts successful launches per kernel —
each wrapper adds one where it launches and nowhere else — so a run can
show that the main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("pack_sign.cu", "xnor_mismatch.cu", "xnor_dot_mxu.cu",
           "quant_pack_planes.cu", "kbit_plane_gemm.cu", "kbit_mxu_gemm.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> argument types before the stream; every launcher is
# (ptr..., int64 dims..., int plane counts..., stream) -> int
_PTRS, _DIMS = ctypes.c_void_p, ctypes.c_longlong
_PROTOTYPES = {
    "repro_pack_sign": 2 * [_PTRS] + 3 * [_DIMS],
    "repro_xnor_mismatch": 3 * [_PTRS] + 3 * [_DIMS],
    "repro_xnor_dot_mxu": 3 * [_PTRS] + 3 * [_DIMS],
    "repro_quant_pack_planes": 3 * [_PTRS] + 3 * [_DIMS] + [ctypes.c_int],
    "repro_kbit_plane_gemm": 3 * [_PTRS] + 3 * [_DIMS] + 2 * [ctypes.c_int],
    "repro_kbit_mxu_gemm": 3 * [_PTRS] + 3 * [_DIMS] + 2 * [ctypes.c_int],
}

LAUNCHES: dict[str, int] = {name[len("repro_"):]: 0 for name in _PROTOTYPES}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on first "
                       "use and need the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD / f"librepro_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these exact sources exists.
    Writes the compiler's register/spill report beside the library
    (``<library>.log``).  Raises with the compiler output on failure."""
    so = library_path()
    if so.exists():
        return so
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{so.stem}.{os.getpid()}"
    procs = []
    for name in SOURCES:
        obj = BUILD / f"{tag}.{Path(name).stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    try:
        for name, _, proc in procs:  # wait for every compiler, even after a failure
            out, _ = proc.communicate()
            logs.append(f"== {name}\n{out}")
            if proc.returncode:
                failed.append(name)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
        tmp = BUILD / f"{tag}.so"
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    finally:
        for _, obj, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            obj.unlink(missing_ok=True)
    if link.returncode:
        raise RuntimeError(f"linking the kernel library failed:\n{link.stdout}")
    os.replace(tmp, so)
    so.with_suffix(".log").write_text(log)
    return so


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    cdll = ctypes.CDLL(str(build()))
    for name, args in _PROTOTYPES.items():
        fn = getattr(cdll, name)
        fn.argtypes = [*args, ctypes.c_void_p]  # ... , cudaStream_t
        fn.restype = ctypes.c_int
    return cdll


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, name: str) -> None:
    if rc:
        raise RuntimeError(f"CUDA kernel {name!r} failed to launch "
                           f"(cudaError {rc})")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    """The checks every wrapper runs before it hands a pointer to C."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every operand lies on the CPU (the wrapper then runs the
    plain version); False when all lie on one CUDA device (the kernel
    runs).  Anything else raises."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"operands on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type == "cuda":
        return False
    raise ValueError(f"unsupported device {dev} (cuda or cpu)")
