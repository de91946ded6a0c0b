"""Build the CUDA kernels under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), for Hopper only:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

The library lands in ``build/kernels/`` at the repository root (listed in
``.gitignore``), named by a hash of the sources, so an edited kernel is
always rebuilt and an unchanged one never is.  A build happens at first
use; :func:`build_all` compiles every kernel at once, one ``nvcc`` process
per source, all started together.  A failed build raises: nothing falls
back to the plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict, List

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("mla_decode_paged", "mla_prefill_paged", "mla_decode",
           "flash_attention_fwd", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.c_longlong
# host arrays: the flash-attention strides (int64) and dims (int32)
_LLP, _IP = ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)
# argtypes of each library's C entry point (csrc/<name>.cu, extern "C")
SIGNATURES = {
    "mla_decode_paged": [_P] * 8 + [_I] * 7 + [_F, _I, _I, _I, _P, _I, _I,
                                                _P],
    "mla_prefill_paged": [_P] * 9 + [_I] * 8 + [_F, _I, _I, _I, _P, _I, _I,
                                                 _P],
    "mla_decode": [_P] * 4 + [_I] * 5 + [_LL] * 4 + [_I, _F, _I, _I, _P, _I,
                                                     _I, _P],
    "flash_attention_fwd": [_P] * 5 + [_LLP, _IP, _F, _P],
    "flash_attention_bwd_dq": [_P] * 7 + [_LLP, _IP, _F, _P],
    "flash_attention_bwd_dkv": [_P] * 8 + [_LLP, _IP, _F, _P],
}

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise FileNotFoundError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
            "CUDA kernels build only where the CUDA toolkit is installed")
    return path


def library_path(name: str) -> pathlib.Path:
    """Where the build of ``csrc/<name>.cu`` goes, keyed by its sources."""
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=KERNELS) -> List[pathlib.Path]:
    """Compile every kernel not built yet, one ``nvcc`` per source, all
    started together; return the library paths.  Raises if any fails."""
    paths = [library_path(n) for n in names]
    todo = [(n, p) for n, p in zip(names, paths) if not p.exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    try:
        for name, out in todo:
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((proc, cmd, tmp, out))
        for proc, cmd, tmp, out in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                   f"{' '.join(cmd)}\n{log}")
            os.replace(tmp, out)      # atomic: readers never see half
    finally:
        for proc, *_ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return paths


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed, with its C entry
    point's argtypes set (every pointer and the stream as c_void_p)."""
    if name not in _loaded:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
        _loaded[name] = lib
    return _loaded[name]
