"""Build and bind the port's CUDA kernels (``repro_torch/csrc/*.cu``).

Each source is compiled on first use by ``nvcc`` into a shared library
with a plain C interface, and loaded with ``ctypes``; no PyTorch header is
included, so a build takes seconds. Libraries go into ``csrc/_build/``
(listed in ``.gitignore``), named by a hash of the sources and flags, so
an edited source rebuilds and an unchanged one is reused. A build writes
to a temporary name and renames it into place, so two processes building
at once do not see half a library.

Nothing here runs at import time, so every module imports on a machine
without the CUDA toolkit (the CPU tests import them all).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "bind", "build", "build_log",
           "int_fn", "library", "nvcc_path", "runs_plain", "sm_count",
           "stream_of"]

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"

#: sm_90a: Hopper with its architecture-specific instructions. No fast-math
#: flags: the kernels' float ops must round exactly as the plain versions.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME``, ``PATH`` or ``/usr/local/cuda``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin); the CUDA kernels need the "
                       "CUDA toolkit")


def _digest(name: str) -> str:
    h = hashlib.blake2b(digest_size=8)
    h.update(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _paths(name: str) -> tuple[pathlib.Path, pathlib.Path]:
    stem = f"{name}-{_digest(name)}"
    return BUILD_DIR / f"{stem}.so", BUILD_DIR / f"{stem}.log"


def build(names) -> dict[str, bool]:
    """Compile every source in ``names`` that has no up-to-date library,
    all ``nvcc`` processes started together. Returns ``{name: built}``
    (False where the cached library was reused); raises with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        so, log = _paths(name)
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       tmp, so, log)
    failed = []
    for name, (proc, tmp, so, log) in procs.items():
        out, _ = proc.communicate()
        log.write_bytes(out)
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode}):\n"
                          + out.decode(errors="replace"))
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {name: name in procs for name in names}


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) from the build of ``name``'s current library, if it was built
    in this build directory."""
    _, log = _paths(name)
    return log.read_text(errors="replace") if log.exists() else ""


def runs_plain(*tensors) -> bool:
    """The wrappers' one dispatch rule: True when every tensor lies on the
    CPU (the plain version runs), False when all lie on one CUDA device
    (the kernel launches). Anything else raises — a CUDA tensor never
    falls back to the plain version."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors lie on several devices: "
                         f"{sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type == "cpu":
        return True
    if dev.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {dev}; the port runs on 'cuda' "
                     f"(kernels) or 'cpu' (plain versions)")


def stream_of(t) -> int:
    """PyTorch's current CUDA stream on ``t``'s device, as a handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def sm_count(t) -> int:
    """The number of SMs of the CUDA device ``t`` lies on (the kernels'
    grids are sized to fill them)."""
    index = t.device.index
    return _sm_count(torch.cuda.current_device() if index is None
                     else index)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/{name}.cu``, built first if needed."""
    build([name])
    so, _ = _paths(name)
    return ctypes.CDLL(str(so))


def bind(lib: ctypes.CDLL, fn: str, n_ptrs: int, n_ints: int):
    """Type ``lib.fn`` as a launch: ``int fn(void* x n_ptrs, int x n_ints,
    void* stream)``, returning the ``cudaError_t``. Pointers and the stream
    must be ``c_void_p``, or ctypes passes them as 32-bit ints."""
    f = getattr(lib, fn)
    f.restype = ctypes.c_int
    f.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                  + [ctypes.c_void_p])
    return f


def int_fn(lib: ctypes.CDLL, fn: str):
    """``lib.fn`` typed as ``int fn(int)``."""
    f = getattr(lib, fn)
    f.restype = ctypes.c_int
    f.argtypes = [ctypes.c_int]
    return f
