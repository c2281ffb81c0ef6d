"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``-gencode=arch=compute_90a,code=sm_90a -O3``) into a shared library
with a plain C interface, at first use, into ``build/torch_ext/`` at the
root of the checkout (listed in ``.gitignore``). The library's file name
carries a hash of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded; the headers under
``csrc/`` (``sm90_common.cuh``, the bf16 attention programs' TMA and
``wgmma`` parts) are hashed into every library's name. It is loaded with
``ctypes``; wrappers pass ``data_ptr()`` and the current stream's handle.

Nothing here includes PyTorch's headers, so a build takes seconds, and
nothing needs ``ninja``. A missing card, a missing ``nvcc`` or a failed
build raises: no caller falls back to the plain versions.

It also holds what the wrappers share: ``LAUNCHES``, the launch counts
(``ops.LAUNCHES``), ``launched``, which counts a call, ``tally``, which
lists the calls of a block with their work, and ``batch_first``,
``fold`` and ``unfold`` for the autograd Functions' vmap rules.

Meta calls. A wrapper given tensors on the ``meta`` device (the
launcher's dry run, ``repro_torch.launch.dryrun``, counts a program
there) checks the shapes it checks on the card and returns empty
``meta`` tensors of its outputs' shapes: it loads no library and
launches nothing. ``launched`` lists such a call in the active tallies
but leaves ``LAUNCHES`` as it is.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections import Counter
from pathlib import Path
from typing import NamedTuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

# library name -> its source files under csrc/
SOURCES = {"sqdist": ("sqdist.cu",),
           "rmsnorm": ("rmsnorm.cu", "rmsnorm_bwd.cu"),
           "attention": ("attention.cu", "attention_sm90.cu",
                         "attention_bwd.cu"),
           "attention_bwd_bf16": ("attention_bwd_bf16.cu",),
           "ssd_scan": ("ssd_scan.cu",),
           "ssd_scan_bwd": ("ssd_scan_bwd.cu",)}

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
        "repro_rmsnorm": (_I, [_I, _I, _I, _I, _P, _P, _P, _LL, _I, _LL,
                               _F, _P]),
        "repro_rmsnorm_bwd": (_I, [_I, _P, _P, _P, _P, _P, _P, _LL, _I, _LL,
                                   _I, _I, _F, _P]),
        **_ERR,
    },
    "attention": {
        "repro_attention": (_I, [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _I, _I, _I, _F, _P]),
        "repro_attention_sm90": (_I, [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                                      _I, _I, _I, _I, _F, _P]),
        "repro_attention_bwd": (_I, [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                     _F, _P]),
        **_ERR,
    },
    "attention_bwd_bf16": {
        "repro_attention_bwd_bf16": (_I, [_I, _I, *[_P] * 10, *[_I] * 7, _F,
                                          _P]),
        **_ERR,
    },
    "ssd_scan": {
        "repro_ssd_scan": (_I, [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _P, _I, _I, _I, _I, _I, _P]),
        "repro_ssd_scan_bt_bytes": (_I, [_I]),
        **_ERR,
    },
    "ssd_scan_bwd": {
        "repro_ssd_scan_bwd": (_I, [_I, *[_P] * 19, *[_I] * 9, _P]),
        **_ERR,
    },
}

_LOADED: dict = {}

# launches by kernel (``ops.LAUNCHES`` is this dict): the wrappers in
# ``ops`` and the autograd Functions of ``flash_attention``, ``rmsnorm``
# and ``ssd_scan`` add one where they launch
LAUNCHES = {"sqdist_rows": 0, "sqdist": 0, "rmsnorm": 0,
            "flash_attention": 0, "swa_attention": 0, "ssd_scan": 0,
            "attention_bwd": 0, "rmsnorm_bwd": 0, "ssd_scan_bwd": 0}


class Call(NamedTuple):
    """One kernel call: its family (a ``LAUNCHES`` key), the name and
    shape that ``repro_torch.analysis.roofline.kernel_work`` takes, its
    dtype, and whether it was counted on ``meta`` (else it launched)."""
    family: str
    work: str
    shape: tuple
    dtype: torch.dtype
    meta: bool


class KernelTally:
    """The kernel calls made while ``tally()`` keeps it active."""

    def __init__(self):
        self.calls = []

    def launches(self) -> Counter:
        """Calls by family."""
        return Counter(c.family for c in self.calls)


_TALLIES: list = []


@contextlib.contextmanager
def tally():
    """A ``KernelTally`` of every kernel call made inside the block,
    launches on the card and meta calls alike."""
    t = KernelTally()
    _TALLIES.append(t)
    try:
        yield t
    finally:
        _TALLIES.remove(t)


def launched(family: str, meta: bool, work, *args) -> None:
    """Count one call of kernel ``family``: in ``LAUNCHES`` where it
    launched (``meta`` False), and in every active tally with
    ``work(*args)``, the (name, shape, dtype) that ``kernel_work``
    takes. ``work`` runs only while a tally is active, so a launch
    outside one costs the wrapper no more host time than the count."""
    if not meta:
        LAUNCHES[family] += 1
    if _TALLIES:
        name, shape, dtype = work(*args)
        for t in _TALLIES:
            t.calls.append(Call(family, name, tuple(shape), dtype, meta))


def given(name: str, shape, dtype: torch.dtype) -> tuple:
    """A ``launched`` work whose (name, shape, dtype) are at hand."""
    return name, shape, dtype


def batch_first(x: torch.Tensor, dim, n: int) -> torch.Tensor:
    """A ``torch.func.vmap`` rule's argument with its vmapped axis first
    (``dim`` None: broadcast to n), contiguous, for the autograd
    Functions' vmap rules to fold into one launch."""
    x = x.expand(n, *x.shape) if dim is None else x.movedim(dim, 0)
    return x.contiguous()


def fold(x: torch.Tensor) -> torch.Tensor:
    """(n, B, ...) -> (n B, ...): a vmap rule's batch-first argument with
    its vmapped axis folded into the next."""
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


def unfold(x: torch.Tensor, n: int) -> torch.Tensor:
    """(n B, ...) -> (n, B, ...), ``fold``'s inverse."""
    return x.reshape(n, x.shape[0] // n, *x.shape[1:])


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
    """Where library ``name`` is built: its file name hashes the flags,
    its sources and every header under ``csrc/`` (a source may include
    any of them)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*SOURCES[name], *sorted(p.name for p in CSRC.glob("*.cuh"))):
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the port's CUDA kernels need a CUDA device and none is "
            "visible (torch.cuda.is_available() is False)")


def build_all(names=None) -> dict:
    """Compile every library (or those ``names``) not built yet, one
    ``nvcc`` per library, all started together. Returns ``{name:
    {"seconds": s, "log": compiler output}}`` for the libraries it built
    (an empty dict when all were built already). Raises if any build
    fails."""
    _require_cuda()
    todo = {n: library_path(n) for n in (names or SOURCES)
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


def current_stream(device_index: int) -> int:
    """The handle of ``device_index``'s current CUDA stream, what
    ``torch.cuda.current_stream(device).cuda_stream`` gives, without
    building a ``Stream`` object, which costs a short kernel's wrapper a
    large share of its host time."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code other than 0."""
    if code != 0:
        msg = lib.repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
