"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each `csrc/<name>.cu` exposes a plain C interface and compiles on first use
with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

into `mmgt_tpu_torch/_build/` (listed in .gitignore). The file name carries
a hash of the source and of the shared headers (`csrc/*.cuh`), so an edited
source never loads a stale library. No source links libcuda: K1, K3, K4 and
K5 look `cuTensorMapEncodeTiled` up through the CUDA runtime
(`cudaGetDriverEntryPoint`, csrc/hopper.cuh).
Every C entry returns `cudaGetLastError()` after its launch; `check` raises
on anything but 0. Nothing here falls back to another path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("flash_attn", "flash_attn_bwd", "group_norm", "ln_proj", "motion_attn")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

VP, INT, FLT, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# argtypes of every C entry: pointers and the stream are c_void_p (ctypes
# would otherwise pass them as 32-bit ints and cut them)
SIGNATURES = {
    "flash_attn": {
        "mmgt_flash_attn": [VP] * 9 + [LL] * 16 + [INT] * 7 + [FLT, VP],
    },
    "flash_attn_bwd": {
        "mmgt_flash_attn_bwd": [VP] * 11 + [LL] * 24 + [INT] * 5 + [FLT, VP],
    },
    "group_norm": {
        "mmgt_group_norm": [VP, VP, INT, VP, INT, VP, VP] + [INT] * 4 + [FLT] + [INT] * 8 + [VP],
        "mmgt_gn_max_clusters": [INT] * 4 + [VP],
    },
    "ln_proj": {
        "mmgt_ln_gemm": [VP] * 3 + [INT] * 2 + [FLT] + [INT] * 3 + [VP] * 3 + [INT] * 3
        + [VP] * 10 + [INT] * 5 + [VP],
    },
    "motion_attn": {
        "mmgt_motion_fused": [VP] * 3 + [INT] + [VP] * 5 + [INT] * 6 + [FLT] * 2 + [INT] * 5
        + [VP],
        "mmgt_ln_pe": [VP] * 3 + [INT] + [VP] * 2 + [LL] + [INT] * 3 + [FLT, VP],
        "mmgt_motion_heads": [VP] * 5 + [INT] * 6 + [FLT] + [INT] * 3 + [VP],
        "mmgt_motion_cluster": [VP] * 5 + [INT] * 6 + [FLT] + [INT] * 4 + [VP],
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels build with nvcc")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # shared headers rebuild every source
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start_build(name: str):
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp, out, cmd


def _finish_build(job) -> None:
    if job is None:
        return
    proc, tmp, out, cmd = job
    log = proc.communicate()[0].decode(errors="replace")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, out)


def build(names: Iterable[str] = SOURCES) -> List[Path]:
    """Compile the named sources, all nvcc processes started together."""
    names = list(names)
    jobs = [_start_build(n) for n in names]
    for job in jobs:
        _finish_build(job)
    return [_lib_path(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        (path,) = build([name])
        lib = ctypes.CDLL(str(path))
        lib.mmgt_error_string.restype = ctypes.c_char_p
        lib.mmgt_error_string.argtypes = [ctypes.c_int]
        for fn_name, types in SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.restype = ctypes.c_int
            fn.argtypes = types
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.mmgt_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t) -> int:
    return 0 if t is None else t.data_ptr()

