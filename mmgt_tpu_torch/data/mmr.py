"""MMR record container: a copy of `mmgt_tpu/data/mmr.py` — the Python
writer and reader, and ctypes bindings for the native C++ prefetching
loader, whose source this package keeps as `csrc/mmr_loader.cpp` (a copy
of `native/mmr_loader.cpp`). `build_native` compiles it with g++ at first
use into `mmgt_tpu_torch/_build/`, named by the hash of the source.

Training records are dense mmap-able arrays; the C++ loader samples random
windows on worker threads into a bounded queue, replacing the reference's
decord-in-__getitem__ pattern (src/dataset/talk_video.py:270-306) with a
GIL-free native path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_DTYPES = {
    np.dtype(np.uint8): 0,
    np.dtype(np.float16): 1,
    np.dtype(np.float32): 2,
    np.dtype(np.int32): 3,
    np.dtype(np.int64): 4,
}
_DTYPES_INV = {v: k for k, v in _DTYPES.items()}

_PKG = Path(__file__).resolve().parents[1]
_SRC_PATH = _PKG / "csrc" / "mmr_loader.cpp"
_LIB_DIR = _PKG / "_build"


def write_mmr(path: str, fields: Dict[str, np.ndarray]) -> str:
    """Write arrays into one MMR1 file (64-byte aligned payload)."""
    header = b"MMR1" + struct.pack("<I", len(fields))
    entries = []
    # first pass: compute header size
    meta_size = len(header)
    for name, arr in fields.items():
        meta_size += 2 + len(name.encode()) + 1 + 1 + 8 * arr.ndim + 8 + 8
    offset = (meta_size + 63) // 64 * 64
    payload = []
    for name, arr in fields.items():
        arr = np.ascontiguousarray(arr)
        code = _DTYPES[arr.dtype]
        nb = arr.nbytes
        entries.append(
            struct.pack("<H", len(name.encode()))
            + name.encode()
            + struct.pack("<BB", code, arr.ndim)
            + struct.pack(f"<{arr.ndim}Q", *arr.shape)
            + struct.pack("<QQ", offset, nb)
        )
        payload.append((offset, arr))
        offset += (nb + 63) // 64 * 64
    with open(path, "wb") as f:
        f.write(header)
        for e in entries:
            f.write(e)
        for off, arr in payload:
            f.seek(off)
            f.write(arr.tobytes())
    return path


def read_mmr(path: str) -> Dict[str, np.ndarray]:
    """Pure-python reader (for tests / when the native lib is absent)."""
    data = np.fromfile(path, np.uint8)
    assert bytes(data[:4]) == b"MMR1", path
    n = struct.unpack("<I", bytes(data[4:8]))[0]
    p = 8
    out = {}
    for _ in range(n):
        (nl,) = struct.unpack("<H", bytes(data[p : p + 2]))
        p += 2
        name = bytes(data[p : p + nl]).decode()
        p += nl
        code, nd = int(data[p]), int(data[p + 1])
        p += 2
        shape = struct.unpack(f"<{nd}Q", bytes(data[p : p + 8 * nd]))
        p += 8 * nd
        off, nb = struct.unpack("<QQ", bytes(data[p : p + 16]))
        p += 16
        arr = data[off : off + nb].view(_DTYPES_INV[code]).reshape(shape)
        out[name] = arr
    return out


def build_native(force: bool = False) -> Optional[Path]:
    """Compile the C++ loader (g++ -O2 -shared) into `_build/`; cached by
    the source's hash. None when it cannot be built."""
    digest = hashlib.sha1(_SRC_PATH.read_bytes()).hexdigest()[:12]
    lib = _LIB_DIR / f"libmmr_loader-{digest}.so"
    if lib.exists() and not force:
        return lib
    _LIB_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
             str(_SRC_PATH), "-o", str(tmp)],
            check=True, capture_output=True,
        )
    except (OSError, subprocess.CalledProcessError):
        return None
    os.replace(tmp, lib)
    return lib


class NativeWindowLoader:
    """Threaded random-window sampler over MMR records (C++ backed)."""

    def __init__(
        self,
        record_paths: Sequence[str],
        fields: Sequence[str] = ("frames", "pose", "face_mask", "lips_mask",
                                 "hands_mask", "audio_emb", "frames_ref"),
        n_frames: int = 12,
        margin: int = 2,
        seed: int = 0,
        n_workers: int = 2,
        queue_depth: int = 8,
    ):
        lib_path = build_native()
        if lib_path is None:
            raise RuntimeError("native mmr_loader could not be built")
        self.lib = ctypes.CDLL(str(lib_path))
        self.lib.mmr_loader_create.restype = ctypes.c_void_p
        self.lib.mmr_loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
            ctypes.c_int, ctypes.c_int,
        ]
        self.lib.mmr_loader_field_info.restype = ctypes.c_int
        self.lib.mmr_loader_field_info.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        self.lib.mmr_loader_next.restype = ctypes.c_int
        self.lib.mmr_loader_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        self.lib.mmr_loader_destroy.argtypes = [ctypes.c_void_p]
        self.fields = list(fields)
        self.n_frames = n_frames

        paths_arr = (ctypes.c_char_p * len(record_paths))(
            *[str(p).encode() for p in record_paths]
        )
        fields_arr = (ctypes.c_char_p * len(self.fields))(
            *[f.encode() for f in self.fields]
        )
        self.handle = self.lib.mmr_loader_create(
            paths_arr, len(record_paths), fields_arr, len(self.fields),
            n_frames, margin, seed, n_workers, queue_depth,
        )
        if not self.handle:
            raise FileNotFoundError(f"no readable MMR records in {record_paths}")

        # field geometry from record 0
        self.shapes: List[Tuple[int, ...]] = []
        self.dtypes: List[np.dtype] = []
        for i, f in enumerate(self.fields):
            shape = (ctypes.c_uint64 * 8)()
            ndim = ctypes.c_int()
            dtype = ctypes.c_int()
            rc = self.lib.mmr_loader_field_info(
                ctypes.c_void_p(self.handle), i, shape, ctypes.byref(ndim),
                ctypes.byref(dtype),
            )
            assert rc == 0, f"field {f} missing from record 0"
            full = tuple(shape[d] for d in range(ndim.value))
            lead = 1 if f == "frames_ref" else n_frames
            self.shapes.append((lead,) + full[1:])
            self.dtypes.append(_DTYPES_INV[dtype.value])

    def next(self) -> Dict[str, np.ndarray]:
        bufs = [
            np.empty(s, d) for s, d in zip(self.shapes, self.dtypes)
        ]
        ptrs = (ctypes.POINTER(ctypes.c_uint8) * len(bufs))(
            *[b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)) for b in bufs]
        )
        clip = ctypes.c_int32()
        ref = ctypes.c_int32()
        start = self.lib.mmr_loader_next(
            ctypes.c_void_p(self.handle), ptrs, len(bufs),
            ctypes.byref(clip), ctypes.byref(ref),
        )
        if start < 0:
            raise StopIteration
        out = {f: b for f, b in zip(self.fields, bufs)}
        # frames_ref holds the whole-window copy starting at ref; reduce to 1
        if "frames_ref" in out:
            out["frames_ref"] = out["frames_ref"][0]
        out["_start"] = np.int32(start)
        out["_clip"] = np.int32(clip.value)
        return out

    def close(self):
        if getattr(self, "handle", None):
            self.lib.mmr_loader_destroy(ctypes.c_void_p(self.handle))
            self.handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
