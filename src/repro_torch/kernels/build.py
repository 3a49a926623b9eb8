"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into an
object (one ``nvcc`` per source, all started together; the ``csrc/*.cuh``
headers are included by them), the objects are linked into one shared
library with a plain C interface, and the library is loaded with
``ctypes``.  The build goes into ``build/`` at the root of the repository
(override with ``REPRO_TORCH_BUILD_DIR``), happens at first use, and is
keyed on the content of the sources and headers, so an unchanged tree
never rebuilds and an edited source never loads a stale library.  Each
build compiles into a directory of its own and renames the finished
library into place, so processes that build at once do not disturb each
other.  A failed build raises with ``nvcc``'s output; nothing here falls
back to anything.

No flag beyond the CUDA toolkit's own is needed: the bf16 attention
kernel writes its ``wgmma`` / TMA / ``mbarrier`` instructions as inline
PTX (no CUTLASS header), and its tensor maps are encoded with the
driver's ``cuTensorMapEncodeTiled``, fetched at run time through the
runtime's ``cudaGetDriverEntryPoint``, so the library links no ``-lcuda``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import torch

from .. import spans
from ..spans import OPEN as _SPANS

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_LIB: Optional[ctypes.CDLL] = None
_INFO: dict = {}
# the walk drives group shards from host threads: the first launch may come
# from two threads at once, and every launch bumps a shared counter
_LOAD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()

_PTR = ctypes.c_void_p
_I64 = ctypes.c_longlong
_F64 = ctypes.c_double
_INT = ctypes.c_int
_F32 = ctypes.c_float

# C signatures (all return the cudaError_t of the launch as int, but the
# size queries of _RESTYPES)
_SIGNATURES = {
    "heye_slowdown_factors": [_PTR, _PTR, _PTR, _PTR, _PTR, _I64, _INT,
                              _F64, _PTR],
    "heye_slowdown_pool": [_PTR, _I64, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
                           _I64, _PTR, _PTR, _INT, _F64, _INT, _PTR, _PTR,
                           _I64, _PTR],
    "heye_slowdown_pool_wide_len": [_I64, _INT],
    "heye_slowdown_same_device_wide_len": [_INT, _INT],
    "heye_slowdown_same_device": [_PTR, _INT, _INT, _PTR, _I64, _PTR, _PTR,
                                  _PTR, _INT, _F64, _PTR, _PTR, _PTR, _PTR,
                                  _PTR, _PTR, _PTR, _I64, _PTR],
    "heye_rate_advance": [_PTR, _PTR, _PTR, _PTR, _PTR, _I64, _F64, _PTR],
    "heye_settle_reprice": [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _I64,
                            _F64, _I64, _PTR],
    "heye_settle_complete": [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _I64, _F64,
                             _F64, _PTR],
    "heye_segment_min": [_PTR, _PTR, _PTR, _PTR, _I64, _PTR],
    "heye_transfer_reprice": [_PTR] * 11 + [_I64, _PTR, _PTR, _I64, _F64,
                                            _I64, _PTR],
    "heye_transfer_complete": [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _I64,
                               _F64, _F64, _PTR],
    "heye_scan_reduce_batch": [_PTR] * 12 + [_I64, _I64, _I64, _I64, _I64,
                                             _F64, _PTR, _PTR],
    "heye_scan_reduce_big": [_PTR] * 11 + [_I64, _I64, _I64, _I64, _F64,
                                           _PTR, _PTR, _I64, _PTR],
    "heye_scan_reduce_big_bytes": [_I64, _I64],
    "heye_rewalk_entry": [_PTR, _I64, _PTR],
    "heye_rewalk_entry_wide_len": [_INT],
    "heye_lru_scan": [_PTR, _PTR, _PTR, _I64, _I64, _I64, _PTR],
    "heye_flash_attention": [_PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT,
                             _INT, _INT, _INT, _INT, _F32, _F32, _PTR],
    "heye_fa_tc_tiles": [_INT, _PTR, _PTR, _PTR],
}
_RESTYPES = {"heye_scan_reduce_big_bytes": _I64,
             "heye_slowdown_pool_wide_len": _I64,
             "heye_slowdown_same_device_wide_len": _I64,
             "heye_rewalk_entry_wide_len": _I64}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.exists():
            exe = str(cand)
    if exe is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "can only be built where the CUDA toolkit is "
                           "installed")
    return exe


def _digest(srcs: list[Path]) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return Path(os.environ.get("REPRO_TORCH_BUILD_DIR",
                               REPO_ROOT / "build")).resolve()


def build() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    out_dir = build_dir() / "repro_torch"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"libheye_kernels_{_digest(srcs + headers())}.so"
    if lib.exists():
        _INFO.setdefault("seconds", 0.0)
        _INFO.setdefault("cached", True)
        _INFO["lib"] = str(lib)
        return lib
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir, prefix="objs_") as work:
        procs = []
        objs = []
        for s in srcs:
            obj = Path(work) / (s.stem + ".o")
            objs.append(obj)
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(obj)]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT,
                                                text=True)))
        log = []
        failed = []
        for cmd, p in procs:
            out, _ = p.communicate()
            log.append(out)
            if p.returncode != 0:
                failed.append((cmd, out))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                " ".join(c) + "\n" + o for c, o in failed))
        tmp = Path(work) / lib.name
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                *(str(o) for o in objs)]
        r = subprocess.run(link, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
        if r.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + " ".join(link) + "\n"
                               + r.stdout)
        os.replace(tmp, lib)
    _INFO.update(seconds=time.perf_counter() - t0, cached=False,
                 lib=str(lib),
                 nvcc_line=" ".join([nvcc, *NVCC_FLAGS, "-c", "csrc/<name>.cu",
                                     "-o", "<name>.o"]) + "  &&  "
                 + " ".join([nvcc, *NVCC_FLAGS, "-shared", "-o",
                             lib.name, "*.o"]),
                 log="".join(log) + r.stdout)
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library (built at first use, once per process
    however many threads ask for it at once)."""
    global _LIB
    if _LIB is None:
        with _LOAD_LOCK:
            if _LIB is None:
                lib = ctypes.CDLL(str(build()))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = _RESTYPES.get(name, _INT)
                _LIB = lib
    return _LIB


def count_launch(counts: dict, name: str) -> None:
    """Add one to ``counts[name]`` (a wrapper's launch counter) — exact
    when wrappers launch from several threads at once — and to the
    innermost open span of the calling thread when a span recorder is
    open."""
    with _COUNT_LOCK:
        counts[name] += 1
        if _SPANS:
            spans.count_launch()


def info() -> dict:
    """Facts about the last build in this process (seconds, nvcc line)."""
    return dict(_INFO)


def check_launch(err: int, name: str) -> None:
    """Raise when a kernel launch was refused (the C wrappers return
    ``cudaGetLastError()`` right after the launch)."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: cudaError {err}")


def raw_stream(device_index: int) -> int:
    """The handle of PyTorch's current stream on a card, for a launch.
    ``torch.cuda.current_stream().cuda_stream`` gives the same handle but
    builds a Python ``Stream`` on every call, host time that a small
    kernel's launch path pays again each call."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def check_tensor(name: str, t: torch.Tensor, dtype, ndim: int, device) -> None:
    """Raise on anything a kernel wrapper does not take."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {t.dim()}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise when autograd would record through a forward-only kernel.

    The kernels have no backward: a result built from ``data_ptr()``s
    carries no ``grad_fn``, so a trainer routed through them would get no
    gradient on the card and silently train without it.  The check runs
    on every device (the CPU's plain versions are differentiable), so a
    CPU test catches such a trainer too.  Training takes the plain route,
    ``ParallelCtx(use_kernels=False)``, as the reference does."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: an input requires grad with autograd "
            "recording; train with ParallelCtx(use_kernels=False), or call "
            "it under torch.no_grad()")


def check_tensors(device, *specs) -> None:
    """:func:`check_tensor` over ``(name, tensor, dtype, ndim)`` specs, a
    fast test first (wrappers on the scheduler's hot path call this once
    per launch)."""
    cuda = device.type == "cuda"
    idx = device.index if cuda else -1
    for name, t, dtype, ndim in specs:
        if not (isinstance(t, torch.Tensor) and t.dtype is dtype
                and t.is_cuda is cuda and t.get_device() == idx
                and t.dim() == ndim and t.is_contiguous()):
            check_tensor(name, t, dtype, ndim, device)
