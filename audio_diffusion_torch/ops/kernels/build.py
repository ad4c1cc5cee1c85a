"""Build and load the port's CUDA sources (``audio_diffusion_torch/csrc``).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with a
plain C interface and loaded with ``ctypes``. The library's file name carries
a hash of the source, the headers beside it (``csrc/*.cuh``) and the flags,
so an edited source builds anew and an unchanged one is loaded from
``audio_diffusion_torch/_build/``. Libraries may be loaded from several
threads at once, one ``nvcc`` each. The build runs
at first use, never at import, and a failed build raises.
:func:`launch_on` calls a library's entry on a device's current stream.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["load_library", "launch_on"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the "
            "CUDA kernels of audio_diffusion_torch are built at first use")
    return nvcc


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and return the loaded library."""
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if not lib.exists():
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # Compile to a private name and rename: a concurrent process never
        # loads a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            os.remove(tmp)
            raise RuntimeError(
                f"nvcc failed on {src.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    return ctypes.CDLL(str(lib))


def launch_on(device, fn, *args) -> int:
    """``fn(*args, stream)`` with ``device`` (a CUDA ``torch.device``)
    current and its current stream passed as a raw pointer: a device guard
    and ``torch.cuda.current_stream`` on every call cost the host about 9 µs
    a launch on an H100's host, so the guard is entered only when another
    device is current."""
    import torch

    index = device.index
    if index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
