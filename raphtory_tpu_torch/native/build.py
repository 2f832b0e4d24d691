"""Compile the native host kernel library on first use, cached by source hash.

The library is plain C ABI consumed via ctypes. Set ``RTPU_NATIVE=0`` to
disable native kernels entirely (pure numpy paths).
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sysconfig
from pathlib import Path

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "kernels.cpp"
_BUILD = _HERE / "_build"


def _lib_suffix() -> str:
    return sysconfig.get_config_var("SHLIB_SUFFIX") or ".so"


def lib_path() -> Path | None:
    """Path of the compiled library, building it if needed. None on failure
    or when RTPU_NATIVE=0."""
    if os.environ.get("RTPU_NATIVE", "1") == "0":
        return None
    try:
        src = _SRC.read_bytes()
    except OSError:
        return None
    tag = hashlib.sha256(src).hexdigest()[:16]
    out = _BUILD / f"librtpu_torch_{tag}{_lib_suffix()}"
    if out.exists():
        return out
    _BUILD.mkdir(exist_ok=True)
    # compile to a per-process temp name, then publish atomically — a killed
    # or concurrent build can never leave a half-written library at `out`
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
        "-fno-math-errno", "-o", str(tmp), str(_SRC),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    except (subprocess.SubprocessError, OSError):
        tmp.unlink(missing_ok=True)
        return None
    return out if out.exists() else None
