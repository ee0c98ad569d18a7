"""Build and load the hand-written CUDA kernels (``kernels/csrc/*.cu``).

Each source has a plain C interface and is compiled by ``nvcc`` for
``sm_90a`` into its own shared library, loaded with ``ctypes``.  The build
happens at first use, reads only the sources in this package and writes to
``build/repro_torch/`` at the root of the checkout (listed in
``.gitignore``).  A library's file name carries a hash of its source and
of the shared headers (``csrc/*.cuh``), so an edited source is rebuilt and
a current one is reused.  ``build_all`` starts
one ``nvcc`` per source at once and waits for all of them.

Nothing here runs at import time, and there is no fallback: a failed build
raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, List

from ..api.errors import KernelBackendError

__all__ = ["SOURCES", "build_dir", "nvcc_command", "build_all", "library",
           "ptr", "stream_of", "check_launch"]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("butterfly_count", "butterfly_sparse", "b2_stack",
           "butterfly_tiled")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")


def build_dir() -> Path:
    """``build/repro_torch/`` at the root of the checkout."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "no CUDA toolkit found (nvcc): the repro_torch kernels are "
            "built from source at first use on a machine with one")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _lib_path(name: str) -> Path:
    """The library of one source, named by a hash of the source and of
    the shared headers it may include."""
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return build_dir() / f"lib{name}-{digest.hexdigest()[:12]}.so"


def nvcc_command(name: str, nvcc: str, out: Path) -> List[str]:
    """The compile line of one source: sm_90a, -O3, a shared library with
    a plain C interface; ``-Xptxas -v`` reports registers and spills."""
    return [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all() -> Dict[str, Path]:
    """Compile every stale source in parallel; return name -> library.

    The compiler's report (``-Xptxas -v``) of each fresh build is kept
    beside the library as ``lib<name>-<hash>.log``.
    """
    out = {name: _lib_path(name) for name in SOURCES}
    todo = [name for name, path in out.items() if not path.exists()]
    if not todo:
        return out
    nvcc = _nvcc()
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = out[name].with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            nvcc_command(name, nvcc, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        out[name].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out[name])      # atomic against concurrent builds
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor, as a ctypes argument."""
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``t``'s device."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check_launch(err: int, what: str) -> None:
    """Raise ``KernelBackendError`` (a ``RuntimeError``) on the
    ``cudaGetLastError()`` code a launch function returned (a refused
    launch never runs, and a later synchronize would not say)."""
    if err != 0:
        raise KernelBackendError(f"{what} launch failed: CUDA error {err}")


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of one source (built first if it is stale),
    with ``argtypes``/``restype`` declared for every entry point."""
    lib = ctypes.CDLL(str(build_all()[name]))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if name == "b2_stack":
        lib.b2_stack_f32.argtypes = [ptr] * 4 + [i32] * 8 + [ptr]
        lib.b2_stack_f32.restype = i32
        lib.b2_stack_pairs_f32.argtypes = (
            [ptr] * 4 + [i32] * 8 + [ptr, i64, ptr])
        lib.b2_stack_pairs_f32.restype = i32
    elif name == "butterfly_count":
        lib.butterfly_count_f32.argtypes = (
            [ptr] * 5 + [i32] * 4 + [ptr, i64, ptr])
        lib.butterfly_count_f32.restype = i32
    elif name == "butterfly_sparse":
        lib.butterfly_update_sparse_f32.argtypes = (
            [ptr] * 8 + [i32] * 9 + [ptr])
        lib.butterfly_update_sparse_f32.restype = i32
        lib.butterfly_update_peel_f32.argtypes = (
            [ptr] * 8 + [i32] * 10 + [ptr, i64, ptr])
        lib.butterfly_update_peel_f32.restype = i32
    elif name == "butterfly_tiled":
        lib.butterfly_update_tiled_f32.argtypes = [ptr] * 7 + [i32] * 4 + [ptr]
        lib.butterfly_update_tiled_f32.restype = i32
        lib.butterfly_update_tiled_peel_f32.argtypes = (
            [ptr] * 7 + [i32] * 7 + [ptr, i64, ptr])
        lib.butterfly_update_tiled_peel_f32.restype = i32
    return lib
