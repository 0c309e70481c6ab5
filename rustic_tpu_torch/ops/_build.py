"""Build, load and launch the CUDA kernels of csrc/.

Each `csrc/<name>.cu` has a plain C interface and becomes its own shared
library, `build/lib<name>-<hash>.so` at the root of the checkout, built
by nvcc at first use; the hash covers the source and the flags, so an
edited source is rebuilt. The library is loaded with ctypes. Every entry
point takes its pointers, then its ints, then the CUDA stream, and
returns the `cudaError_t` of its launch. The host sources, csrc/*.cpp
(the BVH builder and the image decoders' loops), are built the same way
by g++ (`compile_host`).

The wrappers of ops/ share one rule (`uses_plain`): a CPU tensor runs
the kernel's plain PyTorch version, a CUDA tensor runs the kernel, and
any other device is an error. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Per-source extra flags. shade.cu and fused_bounce.cu (the sources that
# include shade_common.cuh) and bvh_traverse.cu are compiled without FMA
# contraction so that they round like their plain PyTorch twins, which
# run one operation per torch kernel; the scans' device code (flash_common.cuh)
# writes its roundings out, so it gives the same bits under either
# setting. No source uses --use_fast_math: the sky march's exp(2.2 log x)
# and the GGX terms need the precise functions.
EXTRA_FLAGS = {
    "flash_intersect": [],
    "flash_multi": [],
    "flash_resident": [],
    "shade": ["-fmad=false"],
    "fused_bounce": ["-fmad=false"],
    "probe_dot": [],
    "bvh_traverse": ["-fmad=false"],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless its library is current; returns the
    library path."""
    return compile_source(os.path.join(CSRC, f"{name}.cu"), EXTRA_FLAGS[name])


def compile_source(src: str, extra_flags=()) -> str:
    """Compile the CUDA source `src` (its includes found in csrc/) into
    build/lib<stem>-<hash>.so unless that library is current: the hash
    covers the source, the *.cuh headers beside it and in csrc/, and the
    flags.
    Returns the library path. The compiler's resource report (-Xptxas -v)
    goes to a .log beside it."""
    flags = ARCH_FLAGS + BASE_FLAGS + ["-I", CSRC] + list(extra_flags)
    h = hashlib.sha256()
    dirs = dict.fromkeys([os.path.dirname(os.path.abspath(src)), CSRC])  # include order
    headers = [os.path.join(d, f) for d in dirs for f in sorted(os.listdir(d)) if f.endswith(".cuh")]
    for path in [src] + headers:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    return _compile(src, h.hexdigest(), [_nvcc(), *flags], "nvcc")


# the JAX package's command for its native BVH builder (native/build.sh,
# rustic_tpu/scene/bvh_native.py): the same flags give the same bits
HOST_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]


def compile_host(src: str) -> str:
    """Compile the host C++ source `src` with g++ and HOST_FLAGS into
    build/lib<stem>-<hash>.so unless that library is current: the hash
    covers the source, the headers it includes with quotes, the flags and
    the target that -march=native names on this host (a checkout copied to
    another machine builds anew).
    Returns the library path; raises RuntimeError with the compiler's
    message when g++ is missing or fails."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ is not on PATH: the port builds {os.path.basename(src)} with it "
                           f"({' '.join(HOST_FLAGS)})")
    # g++ -v prints the target options -march=native expands to
    probe = subprocess.run([gxx, "-march=native", "-E", "-v", "-x", "c++", os.devnull, "-o",
                            os.devnull], capture_output=True, text=True)
    h = hashlib.sha256()
    with open(src, "rb") as f:
        source = f.read()
    h.update(source)
    for name in re.findall(rb'#include "([^"]+)"', source):  # the headers beside it
        with open(os.path.join(os.path.dirname(src), name.decode()), "rb") as f:
            h.update(f.read())
    h.update(" ".join(HOST_FLAGS).encode())
    h.update("".join(ln for ln in probe.stderr.splitlines() if "cc1" in ln).encode())
    return _compile(src, h.hexdigest(), [gxx, *HOST_FLAGS], "g++")


def _compile(src: str, digest: str, cmd, tool: str) -> str:
    """`cmd -o LIB src` into build/lib<stem>-<digest>.so unless it is
    there; the compiler's output goes to a .log beside it."""
    stem = os.path.splitext(os.path.basename(src))[0]
    out = os.path.join(BUILD_DIR, f"lib{stem}-{digest[:12]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"  # builds may race in threads
    cmd = [*cmd, "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    with open(out[: -len(".so")] + ".log", "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"{tool} failed to build {src} (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    return out


def load_entry(lib: str, fn: str, n_ptrs: int, n_ints: int):
    """`fn` of the shared library `lib`, declared as
    `int fn(void* x n_ptrs, int x n_ints, void* stream)`: every pointer
    and the stream are c_void_p, so no 64-bit value is cut."""
    f = getattr(ctypes.CDLL(lib), fn)
    f.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


@functools.lru_cache(maxsize=None)
def entry_point(name: str, fn: str, n_ptrs: int, n_ints: int):
    """`fn` of csrc/<name>.cu (built if needed), declared by `load_entry`."""
    return load_entry(build(name), fn, n_ptrs, n_ints)


def uses_plain(x: torch.Tensor) -> bool:
    """True for a CPU tensor (run the plain version), False for a CUDA
    tensor (run the kernel); any other device has no implementation."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return False


def check(x: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Raise unless `x` is a contiguous `dtype` tensor of `shape` on `device`."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(fn, label: str, device: torch.device, tensors, ints) -> None:
    """Call entry point `fn` on `device`'s current stream with the data
    pointers of `tensors` (None passes a null pointer) and `ints`; raise
    if the launch was refused."""
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    with torch.cuda.device(device):
        rc = fn(*ptrs, *ints, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {label} failed to launch: cudaError {rc}")
