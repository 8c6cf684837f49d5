"""Build and load the port's CUDA kernels.

Every ``dmtpu_torch/csrc/*.cu`` file is compiled by ``nvcc`` for Hopper
(``sm_90a``), with the ``*.cuh`` headers beside it, one ``nvcc`` process per
source, all started together; the objects are then linked into ONE shared
library with a plain C interface, which is loaded with ``ctypes``.  No
PyTorch headers are included, so the build takes seconds.  The build happens at
first use, into ``build/kernels/<digest>/`` under the repository root
(listed in ``.gitignore``); the digest covers the sources, headers and
flags, so an edited kernel is rebuilt.  Concurrent first builds (several
test workers) each compile to a private temporary file and publish it with
an atomic rename, so no process ever loads a half-written library.

Each C entry point takes its pointers and the stream as ``void*`` and returns
the ``cudaError_t`` of its launch; ``check`` turns a non-zero code into an
exception.  There is no fallback: a failed build or launch raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-lineinfo",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # q, k, v, o, lse, B, H, Sq, Sk, D, 12 strides, scale_log2, stream
    "dmtpu_flash_attn_fwd": [_P] * 5 + [_I] * 5 + [_L] * 12 + [_F, _P],
    "dmtpu_flash_attn_fwd_mma": [_P] * 5 + [_I] * 5 + [_L] * 12 + [_F, _P],
    "dmtpu_flash_attn_fwd_mma_d512": [_P] * 5 + [_I] * 5 + [_L] * 12 + [_F, _P],
    # D, Sk: the wgmma forward's dynamic shared memory for such a call, in bytes
    "dmtpu_flash_attn_fwd_smem": [_I, _I],
    # q, k, v, o, dO, lse, delta, dq_acc, dq, dk, dv, B, H, Sq, Sk, D, 21 strides,
    # scale, stream
    "dmtpu_flash_attn_bwd": [_P] * 11 + [_I] * 5 + [_L] * 21 + [_F, _P],
    "dmtpu_flash_attn_bwd_mma": [_P] * 11 + [_I] * 5 + [_L] * 21 + [_F, _P],
    "dmtpu_flash_attn_bwd_mma_d512": [_P] * 11 + [_I] * 5 + [_L] * 21 + [_F, _P],
    # D: the wgmma backward's dynamic shared memory for that head dim, in bytes
    "dmtpu_flash_attn_bwd_smem": [_I],
    # x, weight, bias, y, N, C, HW, G, eps, silu, is_bf16, kernel, cluster, rows, threads,
    # stream
    "dmtpu_group_norm_silu": [_P] * 4 + [_I] * 4 + [_F] + [_I] * 6 + [_P],
    # x, weight, bias, y, N, C, HW, G, eps, silu, is_bf16, form, team, ctas, scratch, epoch,
    # stream
    "dmtpu_group_norm_team": [_P] * 4 + [_I] * 4 + [_F] + [_I] * 5 + [_P, _L, _P],
    # x, weight, bias, y, N, C, HW, G, eps, silu, is_bf16, held, cluster, periods, threads,
    # stream
    "dmtpu_group_norm_chunks": [_P] * 4 + [_I] * 4 + [_F] + [_I] * 6 + [_P],
    # C, HW, G, is_bf16, held, cluster, threads: the chunks kernel's dynamic shared
    # memory for such a launch, in bytes
    "dmtpu_group_norm_chunks_smem": [_I] * 7,
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the port's kernels are built from source on a CUDA machine")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build() -> Path:
    """Compile the kernels if needed; returns the library's path."""
    sources = _sources()
    digest = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):  # the sources and the headers they include
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib = out_dir / "libdmtpu_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    tmp = out_dir / f".libdmtpu_kernels.so.{pid}"
    objects = [out_dir / f".{src.stem}.{pid}.o" for src in sources]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources, objects)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    steps = [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in zip(cmds, procs)]
    if all(rc == 0 for *_, rc in steps):
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objects)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        steps.append((cmd, proc.stdout, proc.returncode))
    for obj in objects:
        obj.unlink(missing_ok=True)
    (out_dir / "build.log").write_text("".join(" ".join(cmd) + "\n" + out
                                               for cmd, out, _ in steps))
    failed = [(cmd, out, rc) for cmd, out, rc in steps if rc != 0]
    if failed:
        tmp.unlink(missing_ok=True)
        cmd, out, rc = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out[-4000:]}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in this process)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.dmtpu_cuda_error_string.argtypes = [ctypes.c_int]
    lib.dmtpu_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        msg = library().dmtpu_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
