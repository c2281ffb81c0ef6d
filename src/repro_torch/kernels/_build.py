"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``-gencode=arch=compute_90a,code=sm_90a -O3``) into a shared library
with a plain C interface, at first use, into ``build/torch_ext/`` at the
root of the checkout (listed in ``.gitignore``). The library's file name
carries a hash of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded. It is loaded with
``ctypes``; wrappers pass ``data_ptr()`` and the current stream's handle.

Nothing here includes PyTorch's headers, so a build takes seconds, and
nothing needs ``ninja``. A missing card, a missing ``nvcc`` or a failed
build raises: no caller falls back to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

# library name -> its source files under csrc/
SOURCES = {"sqdist": ("sqdist.cu",), "rmsnorm": ("rmsnorm.cu",),
           "attention": ("attention.cu", "attention_sm90.cu"),
           "ssd_scan": ("ssd_scan.cu",)}

# library name -> the C functions it exports: (restype, argtypes)
_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
_ERR = {"repro_cuda_error_string": (ctypes.c_char_p, [_I])}
SIGNATURES = {
    "sqdist": {
        "repro_sqdist_rows": (_I, [_I, _P, _P, _P, _P, _P, _LL, _LL, _LL,
                                   _I, _LL, _P]),
        **_ERR,
    },
    "rmsnorm": {
        "repro_rmsnorm": (_I, [_I, _P, _P, _P, _LL, _I, _F, _P]),
        **_ERR,
    },
    "attention": {
        "repro_attention": (_I, [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                 _I, _F, _P]),
        "repro_attention_sm90": (_I, [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                      _I, _I, _F, _P]),
        **_ERR,
    },
    "ssd_scan": {
        "repro_ssd_scan": (_I, [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _P, _I, _I, _I, _I, _I, _P]),
        "repro_ssd_scan_bt_bytes": (_I, [_I]),
        **_ERR,
    },
}

_LOADED: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on the PATH,
    or ``/usr/local/cuda/bin/nvcc``."""
    candidates = [os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                  shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked at $CUDA_HOME/bin, the PATH and "
        "/usr/local/cuda/bin): the port's CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES[name]:
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the port's CUDA kernels need a CUDA device and none is "
            "visible (torch.cuda.is_available() is False)")


def build_all() -> dict:
    """Compile every library that is not built yet, one ``nvcc`` per
    library, all started together. Returns ``{name: {"seconds": s,
    "log": compiler output}}`` for the libraries it built (an empty dict
    when all were built already). Raises if any build fails."""
    _require_cuda()
    todo = {n: library_path(n) for n in SOURCES
            if not library_path(n).exists()}
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, out in todo.items():
        # a private temporary name, then an atomic rename: processes that
        # build the same library at once never load a half-written file
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               *(str(CSRC / s) for s in SOURCES[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out, time.perf_counter())
    report, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        report[name] = {"seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("nvcc failed to build " + "\n".join(failed))
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    _require_cuda()
    path = library_path(name)
    if not path.exists():
        build_all()
    lib = ctypes.CDLL(str(path))
    for fn, (restype, argtypes) in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.restype, f.argtypes = restype, argtypes
    _LOADED[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code other than 0."""
    if code != 0:
        msg = lib.repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
