"""Build and load the port's CUDA kernels.

At first use, `nvcc` compiles every `csrc/*.cu` of this package for sm_90a
(Hopper), one process per source, all started together, and links the
objects into one shared library with a plain C interface, in
`matten_tpu_torch/_build/<hash of the sources>/`; the library is loaded
with ctypes. A changed source gets a new directory, so a stale build is
never loaded. A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
LIB_NAME = "libmatten_tpu_torch_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lib: Optional[ctypes.CDLL] = None


def _sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build_dir() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (once per source hash); returns the library path."""
    out_dir = build_dir()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    log, objs, procs = [], [], []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        fd, obj = tempfile.mkstemp(suffix=".o", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        objs.append(obj)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        failed = []
        for cmd, proc in procs:
            out, _ = proc.communicate()
            log.append(" ".join(cmd) + "\n" + out)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n{out}")
        if not failed:
            cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        (out_dir / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError("\n".join(failed))
        os.replace(tmp, lib_path)
    finally:
        for f in objs + [tmp]:
            if os.path.exists(f):
                os.unlink(f)
    return lib_path


def load_library() -> ctypes.CDLL:
    """Build if needed, load once, and declare the C signatures. The build
    and load are the span "kernels.load" of the tracer (`utils.timing`),
    recorded whether it is on or not: the first step that launches a
    kernel holds them, and a reader of that step's time can take them out."""
    global _lib
    if _lib is not None:
        return _lib
    from matten_tpu_torch.utils import timing

    with timing.span("kernels.load", always=True):
        lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_uvu_conv_fwd.argtypes = [p] * 16 + [i] * 13 + [p]
    lib.fused_uvu_conv_fwd.restype = ctypes.c_int
    lib.fused_uvu_conv_bwd.argtypes = [p] * 17 + [i] * 13 + [p]
    lib.fused_uvu_conv_bwd.restype = ctypes.c_int
    lib.segment_sum.argtypes = [p] * 4 + [i] * 3 + [p]
    lib.segment_sum.restype = ctypes.c_int
    lib.stamp.argtypes = [p, p]
    lib.stamp.restype = ctypes.c_int
    for kind in ("fwd", "bwd"):
        fn = getattr(lib, f"fused_uvu_conv_{kind}_smem")
        fn.argtypes = [i] * 9
        fn.restype = ctypes.c_size_t
    _lib = lib
    return lib
