"""Hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The directory contract
----------------------
Each kernel family `<name>` (ntt, modops, baseconv, rotate_reduce,
flash_attn) ships

  csrc/<name>.cu      the CUDA C++ source, plain C entry points
                      (`<fn>_launch`) that take raw device pointers and
                      the stream, launch, and return `cudaGetLastError()`;
                      shared device code lives in csrc/*.cuh
                      (u32.cuh: modular arithmetic)
  <name>/<name>.py    the launch wrappers: check device, dtype, shape and
                      contiguity, allocate the output, launch on PyTorch's
                      current stream, raise on a non-zero return, and add
                      one to `LAUNCHES[<fn>]` — a plain int — at the
                      launch and nowhere else
  <name>/ref.py       the plain PyTorch version of the same function
  <name>/ops.py       the public entry: a CUDA tensor goes to the kernel
                      (or raises), a CPU tensor goes to the plain version

and a source note naming the function it replaces in the JAX package,
what bounds it on the card and what its design does about that.

Building
--------
`library(name)` compiles csrc/<name>.cu with nvcc for sm_90a into a
shared library under `_build/` (git-ignored) at first use and loads it
with ctypes.  `build_all()` starts one nvcc per source at once.  A build
that fails raises `KernelBuildError` with nvcc's stderr; nothing is ever
returned in a kernel's place.  Nothing here runs at import time: the
CPU-only test environment imports every module without nvcc or a card.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

SOURCES = ("ntt", "modops", "baseconv", "rotate_reduce", "flash_attn")

_CSRC = os.path.join(os.path.dirname(__file__), "csrc")
_BUILD = os.path.join(os.path.dirname(__file__), "_build")
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise KernelBuildError("nvcc not found on PATH or under CUDA_HOME; "
                           "the CUDA kernels cannot be built here")


def _target(name: str, csrc: str = _CSRC) -> tuple[str, str]:
    """(source path, library path keyed by the content of the source and
    of every header in csrc/, so a changed header gives a new library)."""
    src = os.path.join(csrc, f"{name}.cu")
    headers = sorted(f for f in os.listdir(csrc) if f.endswith(".cuh"))
    h = hashlib.sha256()
    for path in (src, *(os.path.join(csrc, f) for f in headers)):
        h.update(os.path.basename(path).encode() + b"\0")
        with open(path, "rb") as f:
            h.update(f.read())
    return src, os.path.join(_BUILD, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for one source unless its library exists; returns
    (library path, temporary output path, Popen) with None for the last
    two when there is nothing to build."""
    src, lib = _target(name)
    if os.path.exists(lib):
        return lib, None, None
    nvcc = nvcc_path()
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.Popen([nvcc, *_NVCC_FLAGS, "-o", tmp, src],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return lib, tmp, proc


def _finish(name: str, lib: str, tmp, proc) -> None:
    if proc is None:
        return
    _, err = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise KernelBuildError(f"nvcc failed on csrc/{name}.cu "
                               f"(exit {proc.returncode}):\n{err}")
    os.replace(tmp, lib)


def build_all() -> None:
    """Compile every kernel source, one nvcc each, all started together."""
    started = [(name, *_start(name)) for name in SOURCES]
    for name, lib, tmp, proc in started:
        _finish(name, lib, tmp, proc)


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of csrc/<name>.cu, built at first use."""
    if name not in _LIBS:
        lib, tmp, proc = _start(name)
        _finish(name, lib, tmp, proc)
        _LIBS[name] = ctypes.CDLL(lib)
    return _LIBS[name]


def on_device(device):
    """Context in which `device` is the current CUDA device — what a raw
    launch on one of its streams needs.  Free when it already is."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _tables() -> tuple[dict[str, int], ...]:
    """Every kernel wrapper's `LAUNCHES` table."""
    from .baseconv import baseconv
    from .flash_attn import flash_attn
    from .modops import modops
    from .ntt import ntt
    from .rotate_reduce import rotate_reduce
    return (ntt.LAUNCHES, modops.LAUNCHES, baseconv.LAUNCHES, rotate_reduce.LAUNCHES,
            flash_attn.LAUNCHES)


def launch_counts() -> dict[str, int]:
    """Launches made so far by every kernel wrapper, by kernel name."""
    return {name: n for table in _tables() for name, n in table.items()}


def reset_launch_counts() -> None:
    from .baseconv import baseconv
    from .modops import modops
    from .ntt import ntt
    for table in _tables():
        for key in table:
            table[key] = 0
    for by_shape in (*ntt.LAUNCHES_BY_ROWS.values(), *modops.LAUNCHES_BY_SHAPE.values(),
                     *baseconv.LAUNCHES_BY_SHAPE.values()):
        by_shape.clear()
