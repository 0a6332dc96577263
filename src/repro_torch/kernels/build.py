"""Build and load the port's CUDA kernels.

The sources under ``src/repro_torch/csrc/`` (``*.cu``, which include the
``*.cuh`` headers there) are compiled with ``nvcc``, one process per
source, all started together, and linked into one shared library with a
plain C interface, loaded with ``ctypes``.  The library goes to
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``) on
first use, named by the hash of the sources, headers and flags, so a changed
source is rebuilt and an unchanged one is loaded as it is.

Nothing falls back: a missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parents[1] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points and their argument types: pointers and the stream as
# c_void_p (a plain int would be cut to 32 bits), sizes as c_int.
SIGNATURES = {
    "nm_spmm_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "nm_spmm_int8": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "fused_sparse_linear_bf16": [_P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _P],
    "fused_sparse_linear_int8": [_P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _P],
    "fused_sparse_linear_decode_bf16": [_P] * 8 + [_I] * 9 + [_P],
    "fused_sparse_linear_decode_int8": [_P] * 9 + [_I] * 9 + [_P],
    "fused_sparse_linear_prefill_bf16": [_P] * 8 + [_I] * 10 + [_P],
    "fused_sparse_linear_prefill_int8": [_P] * 9 + [_I] * 10 + [_P],
    "nm_spmm_decode_bf16": [_P] * 6 + [_I] * 8 + [_P],
    "nm_spmm_decode_int8": [_P] * 7 + [_I] * 8 + [_P],
    "nm_spmm_prefill_bf16": [_P] * 6 + [_I] * 9 + [_P],
    "nm_spmm_prefill_int8": [_P] * 7 + [_I] * 9 + [_P],
    "outlier_spmm_decode_bf16": [_P] * 6 + [_I] * 8 + [_P],
    "outlier_spmm_prefill_bf16": [_P] * 6 + [_I] * 8 + [_P],
    "outlier_spmm_gather8_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "paged_attention_bf16": [_P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "paged_attention_int8": [_P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "paged_attention_prefill_bf16": [_P] * 6 + [_I] * 10 + [_P],
    "paged_attention_prefill_int8": [_P] * 8 + [_I] * 10 + [_P],
    "paged_attention_decode_bf16": [_P] * 8 + [_I] * 10 + [_P],
    "paged_attention_decode_int8": [_P] * 10 + [_I] * 10 + [_P],
}

_lib: ctypes.CDLL | None = None


def sources() -> list[pathlib.Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def headers() -> list[pathlib.Path]:
    return sorted(CSRC_DIR.glob("*.cuh"))


def include_flags() -> list[str]:
    """For a copy of a source compiled outside ``csrc/`` (the A/B scripts):
    its headers' directory."""
    return ["-I", str(CSRC_DIR)]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest(srcs: list[pathlib.Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run(cmds: list[list[str]], verbose: bool) -> None:
    """Run the commands in parallel; raise with the output of any that
    failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{output}")
        elif verbose:
            print(output, end="")
    if failed:
        raise RuntimeError("\n".join(failed))


def build(verbose: bool = False) -> pathlib.Path:
    """Compile the sources into ``build/kernels/`` unless a library with the
    same hash is there already; returns the library's path."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    lib_path = BUILD_DIR / f"libkernels-{_digest(srcs + headers())}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{lib_path.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in srcs]
    _run([[nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-c", "-o", str(obj), str(src)] for src, obj in zip(srcs, objs)],
         verbose)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]],
         verbose)
    for obj in objs:
        obj.unlink()
    os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(status: int, name: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")
