"""Build and load the package's CUDA kernels (csrc/*.cu).

nvcc compiles every source to an object, one process per source, all
started together, and links the objects into one shared library with a
plain C interface, loaded with ctypes (no PyTorch headers, so a build takes
seconds). The sources share csrc/*.cuh headers.
The library lands in `_build/` beside this file, under a name that carries a
hash of the sources, the headers and the flags: a changed file builds anew,
an unchanged set is loaded as it is. Nothing is built when the package is imported, only at
the first kernel launch (or an explicit `load()`). A missing nvcc or a failed
compile raises.

Flags: `sm_90a` (Hopper), no `--use_fast_math` (the sphere loop relies on
sqrt of a negative being NaN, and the kernels keep IEEE sqrt and division),
and `-fmad=false` so the kernels round every product and sum as the plain
PyTorch versions do.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

from .utils import tracing

_DIR = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_DIR, "csrc")
_OUT = os.path.join(_DIR, "_build")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
         "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_F = ctypes.c_float
# C entry points: (argtypes); each returns the cudaError_t of its launch
_SIGNATURES = {
    "pt_fused_bounce": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                        _P, _I, _I, _P, _P, _I, _I,
                        _U, _U, _U, _U, _F, _F, _F, _F, _F, _F, _I, _I, _I,
                        _P],
    "pt_compact_blocks": [_P, _P, _P, _P, _P, _I, _P],
    "pt_intersect_spheres": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _P],
    "pt_intersect_tris": [_P, _I, _P, _P, _P, _P, _P, _I, _P],
    "pt_gather_chunks": [_P, _P, _P, _P, _I, _P, _I, _P, _F, _F, _I, _I,
                         _P, _P, _I, _P],
    "pt_intersect_tile_tris": [_P, _I, _P, _P, _I, _I, _I, _P, _I, _P, _P,
                               _P, _P, _P, _P],
    "pt_bvh8_walk": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                     _I, _P],
    "pt_bvh4_walk": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                     _I, _I, _P],
    "pt_intersect_state": [_P, _I, _P, _P, _P, _I, _P, _I, _I, _P, _P, _I,
                           _I, _P, _P, _I, _I, _P],
    "pt_shade_state": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _U, _U, _U, _U,
                       _F, _F, _F, _F, _F, _F, _I, _I, _P],
    "pt_intersect_clustered": [_P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _P,
                               _P, _P, _I, _P],
    "pt_gather_flux": [_P, _P, _P, _P, _I, _F, _P, _I, _P, _I, _P],
    "pt_winner_t": [_P] * 10 + [_I, _P],
    "pt_mesh_bounce": [_P] * 13 + [_I] + [_P] * 8 + [_U] * 4 + [_P, _I, _P],
}

_lib = None
build_log = ""  # ptxas register / shared-memory report of the last build


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build the CUDA kernels")


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sorted(_sources() + glob.glob(os.path.join(_CSRC, "*.cuh"))):
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(_OUT, f"libpt_kernels_{h.hexdigest()[:16]}.so")


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    global _lib
    if _lib is not None:
        return _lib
    with tracing.span("build.kernels"):
        _lib = _build_and_load()
    return _lib


def _build_and_load() -> ctypes.CDLL:
    global build_log
    so = library_path()
    if not os.path.exists(so):
        os.makedirs(_OUT, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        nvcc = nvcc_path()
        objs = [f"{tmp}.{os.path.basename(src)}.o" for src in _sources()]
        procs = [subprocess.Popen([nvcc, *FLAGS, "-c", "-o", obj, src],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(_sources(), objs)]
        logs = [(p.args[-1], p.communicate()[0], p.returncode) for p in procs]
        build_log = "".join(log for _, log, _ in logs)
        failed = [f"{src} ({rc}):\n{log}" for src, log, rc in logs if rc]
        if not failed:
            res = subprocess.run([nvcc, *FLAGS, "-shared", "-o", tmp, *objs],
                                 capture_output=True, text=True)
            if res.returncode:
                failed.append(f"link ({res.returncode}):\n{res.stdout}"
                              f"{res.stderr}")
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.pt_error_string.argtypes = [ctypes.c_int]
    lib.pt_error_string.restype = ctypes.c_char_p
    lib.pt_bvh4_cache_rows.argtypes = []
    lib.pt_bvh4_cache_rows.restype = ctypes.c_int
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.pt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
