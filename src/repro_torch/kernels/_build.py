"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` are compiled at first use with ``nvcc`` for
Hopper (``sm_90a``) into one shared library with a plain C interface,
loaded with :mod:`ctypes`.  Each source compiles in its own ``nvcc``
process, all started together, then one link.  The library lands in
``build/repro_torch_kernels/<hash of sources and flags>/`` at the root of
the checkout, so a changed source rebuilds and an unchanged one loads at
once.

No ``nvcc`` or a failed build raises :class:`KernelBuildError`: there is
no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("flash_attention.cu", "paged_decode_attention.cu", "decode_attention.cu",
           "ssd_scan.cu", "rglru_scan.cu", "stream.cu")
HEADERS = ("common.cuh", "mma.cuh", "wgmma.cuh", "decode_attention.cuh")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                       "-Xptxas", "-v"]
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

# what the kernels are instantiated for: dtype codes of csrc/common.cuh,
# and head dims
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # q, k, v, o, B, S, H, KV, Dh, causal, window, valid_len, group,
    # consumers, split, dtype, stream
    "repro_flash_attention_fwd": [_P, _P, _P, _P] + [_I] * 12 + [_P],
    # q, k_pages, v_pages, page_table, lengths, ws, o, B, H, KV, Dh, page,
    # maxp, splits, tps, dtype, stream
    "repro_paged_decode_attention_fwd": [_P] * 7 + [_I] * 9 + [_P],
    # q, k, v, lengths, ws, o, B, T, H, KV, Dh, splits, tps, dtype, stream
    "repro_decode_attention_fwd": [_P] * 6 + [_I] * 8 + [_P],
    # x, dt, A, Bm, Cm, ws, y, final_state, B, S, H, P, G, N, chunk, chunks,
    # dtype, dt_dtype, stream
    "repro_ssd_scan_fwd": [_P] * 8 + [_I] * 10 + [_P],
    # a, b, ws, h, B, S, W, chunks, dtype, stream
    "repro_rglru_scan_fwd": [_P] * 4 + [_I] * 5 + [_P],
    # a, b, o, n, alpha, dtype, stream
    "repro_stream_triad": [_P] * 3 + [ctypes.c_longlong, ctypes.c_float, _I, _P],
}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_info: Dict[str, object] = {}  # seconds, directory, ptxas report


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise KernelBuildError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels cannot be built")


def _digest(nvcc: str) -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join([nvcc] + CFLAGS).encode())
    return h.hexdigest()[:16]


def _run_all(cmds: List[List[str]]) -> List[str]:
    """Run the commands in parallel; raise on the first failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = []
    failed = []
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate()
        outs.append(out)
        if p.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(failed))
    return outs


def build() -> Path:
    """Compile the sources (if this exact build is not there yet) and
    return the path of the shared library."""
    nvcc = find_nvcc()
    out_dir = BUILD_ROOT / _digest(nvcc)
    lib_path = out_dir / "librepro_torch_kernels.so"
    if lib_path.exists():
        build_info.update(seconds=0.0, directory=str(out_dir), cached=True)
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    objs = [out_dir / (Path(s).stem + f".{os.getpid()}.o") for s in SOURCES]
    reports = _run_all([[nvcc, *CFLAGS, "-c", str(CSRC / s), "-o", str(o)]
                        for s, o in zip(SOURCES, objs)])
    tmp = out_dir / f"lib.{os.getpid()}.so"
    _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
    os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or nothing
    for o in objs:
        o.unlink(missing_ok=True)
    report = "\n".join(reports)
    (out_dir / "ptxas.txt").write_text(report)
    build_info.update(seconds=time.perf_counter() - t0, directory=str(out_dir),
                      cached=False, ptxas=report)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check_tensors(what: str, like: torch.Tensor, named, dtype=None) -> None:
    """Raise unless every (name, tensor) is contiguous on ``like``'s CUDA
    device and, where ``dtype`` is given, has that dtype (a float dtype
    must be one the kernels are instantiated for)."""
    # device indices, not torch.device objects: this runs on every launch
    dev = like.get_device()
    bad_dtype = dtype is not None and dtype.is_floating_point and dtype not in DTYPES
    for name, t in named:
        if not t.is_cuda or t.get_device() != dev:
            raise ValueError(f"{what}: {name} must be on the CUDA device of the "
                             f"first input, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if dtype is not None and (t.dtype != dtype or bad_dtype):
            raise TypeError(f"{what}: {name} has dtype {t.dtype}; expected "
                            f"{dtype} (floats: float32 or bfloat16)")


# (device index, raw stream, thread) -> the kernels' fp32 scratch
_workspaces: Dict[Tuple[int, int, int], torch.Tensor] = {}
WORKSPACE = object()  # stands in :func:`launch`'s args for the scratch pointer


def workspace(device_index: int, stream: int, numel: int) -> int:
    """A pointer to ``numel`` fp32 floats of scratch: one ``torch.empty``
    per (device, stream, thread), kept and grown as the shapes need it and
    shared by every kernel that takes scratch, so a call makes no
    allocator call.  Reuse is safe: the launches on one stream run in
    order, so a call's last kernel has read its scratch before the next
    call's first kernel writes there, and each thread has its own buffer,
    since two threads' launches on one stream may interleave."""
    key = (device_index, stream, threading.get_ident())
    ws = _workspaces.get(key)
    if ws is None or ws.numel() < numel:
        ws = torch.empty(numel, dtype=torch.float32, device=f"cuda:{device_index}")
        _workspaces[key] = ws
    return ws.data_ptr()


def launch(entry: str, what: str, like: torch.Tensor, *args, ws_floats: int = 0) -> None:
    """Call the C entry point with ``args`` and PyTorch's current stream,
    on ``like``'s device, with :data:`WORKSPACE` in ``args`` replaced by
    the :func:`workspace` pointer to ``ws_floats`` floats; raise if the
    launch returned a CUDA error."""
    fn = getattr(library(), entry)
    dev = like.get_device()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if ws_floats:
            ptr = workspace(dev, stream, ws_floats)
            args = tuple(ptr if a is WORKSPACE else a for a in args)
        err = fn(*args, stream)
    check(err, what)


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = library().repro_cuda_error_string(err).decode()
        raise KernelLaunchError(f"{what}: CUDA error {err} ({msg})")
