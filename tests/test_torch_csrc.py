"""The ctypes signatures in `_build.SIGNATURES` match the C entries of the
CUDA sources, so a changed C signature fails here on the CPU and not on
the card. Each `extern "C"` entry of `csrc/<name>.cu` (other than
`mmgt_error_string`) must be listed with one ctypes type per argument:
c_void_p for a pointer, c_longlong for a long long, c_int for an int,
c_float for a float."""
import ctypes
import re

import pytest

from mmgt_tpu_torch.ops import _build

_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)


def _ctype(arg: str):
    arg = " ".join(arg.split())
    if "*" in arg:
        return ctypes.c_void_p
    if arg.startswith("long long"):
        return ctypes.c_longlong
    if arg.startswith("int"):
        return ctypes.c_int
    if arg.startswith("float"):
        return ctypes.c_float
    raise AssertionError(f"unexpected C argument type: {arg!r}")


def _entries(name: str) -> dict:
    src = (_build.CSRC / f"{name}.cu").read_text()
    src = re.sub(r"//[^\n]*", "", src)
    return {fn: [_ctype(a) for a in args.split(",")] for fn, args in _ENTRY.findall(src)}


def test_every_source_has_signatures():
    on_disk = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert sorted(_build.SOURCES) == on_disk
    assert sorted(_build.SIGNATURES) == on_disk


@pytest.mark.parametrize("name", _build.SOURCES)
def test_signatures_match_c_entries(name):
    entries = _entries(name)
    assert entries, f"no extern \"C\" int entry in {name}.cu"
    assert set(entries) == set(_build.SIGNATURES[name])
    for fn, types in entries.items():
        assert _build.SIGNATURES[name][fn] == types, fn


def test_error_string_entry_in_every_source():
    for name in _build.SOURCES:
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert 'extern "C" const char* mmgt_error_string(int e)' in src, name
