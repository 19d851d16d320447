"""On-demand builds of the package's native and CUDA sources.

Everything is built at first use into `tpupt_torch/build/`, which git
ignores; nothing is written next to the sources."""

from __future__ import annotations

import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "build")


def compile_shared(cmd_prefix, src: str, out: str) -> str:
    """Run `cmd_prefix + [src, "-o", tmp]` and move tmp onto `out` in one
    step, so that concurrent processes never load a half-written library.
    Returns what the compiler printed."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(list(cmd_prefix) + [src, "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{cmd_prefix[0]} failed on {src}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
        return proc.stdout + proc.stderr
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def is_stale(out: str, *srcs: str) -> bool:
    return (not os.path.exists(out)
            or any(os.path.getmtime(out) < os.path.getmtime(s) for s in srcs))


CSRC_DIR = os.path.join(_PKG, "csrc")
# -fmad=false: no contraction of a*b+c into one fused operation, so a
# kernel's edge functions and slab products round as PyTorch's eager kernels
# do and the kernel equals its plain version bit for bit.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
            if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
                nvcc = os.path.join(root, "bin", "nvcc")
                break
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def cuda_source(name: str) -> str:
    return os.path.join(CSRC_DIR, name)


def cuda_library(name: str) -> str:
    """Path in BUILD_DIR of the shared library made from csrc/<name>.cu."""
    return os.path.join(BUILD_DIR, f"libtpupt_{name}.so")


def build_cuda(name: str, extra_flags=(), out: str = None):
    """Compile csrc/<name>.cu into a shared library with nvcc. Returns (path,
    what nvcc printed). `extra_flags` come after NVCC_FLAGS, so a later
    -fmad wins."""
    out = out or cuda_library(name)
    log = compile_shared([find_nvcc()] + NVCC_FLAGS + list(extra_flags),
                         cuda_source(name + ".cu"), out)
    return out, log


def cuda_is_stale(name: str) -> bool:
    """The library of csrc/<name>.cu is missing or older than its source or
    the header the kernels share."""
    return is_stale(cuda_library(name), cuda_source(name + ".cu"),
                    cuda_source("traverse_common.cuh"))
