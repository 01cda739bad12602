"""Build the hand-written CUDA kernels and bind them with ctypes.

All ``csrc/*.cu`` sources compile with ``nvcc`` for Hopper (``sm_90a``)
into ONE shared library with a plain C interface, placed under
``build/repro_torch_kernels/<hash of the sources and flags>/`` at the root
of the checkout (under the user's cache directory when the package is
installed).  The build runs at first use (one ``nvcc -c`` per source,
all started together, then one link) and is reused while the sources are
unchanged.  Nothing is installed or downloaded: a missing ``nvcc`` or a
failed compile raises with the compiler's output, and no caller falls back
to another path.

The C entry points take device pointers and the CUDA stream as
``ctypes.c_void_p`` (``tensor.data_ptr()``,
``torch.cuda.current_stream().cuda_stream``), ints as ``ctypes.c_int``,
floats as ``ctypes.c_float`` and strides as ``ctypes.c_longlong``;
each launches on the given stream, never synchronises, and returns
``cudaGetLastError()``, which :func:`check` turns into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
LIB_NAME = "librepro_torch_kernels.so"


def _build_root() -> Path:
    """``<checkout>/build/repro_torch_kernels`` when the package runs from a
    source checkout (``<checkout>/src/repro_torch``); after an install, the
    user's cache directory, so no checkout shares the install's prefix."""
    pkg = Path(__file__).resolve().parents[1]
    if pkg.parent.name == "src" and (pkg.parents[1] / "pyproject.toml").exists():
        return pkg.parents[1] / "build" / "repro_torch_kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "repro_torch_kernels"


BUILD_ROOT = _build_root()

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# no --use_fast_math: keys are only compared and moved, and denormals must
# not be flushed behind the pass's back (the entry flush is explicit)
CFLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_RWKV6 = [_P] * 8 + [_I] * 4 + [_L] * 12 + [_I, _P]
# C signature of every entry point: name -> argtypes (restype is int)
SIGNATURES = {
    # a, size, K, cap, ne (a device int32), c_max, ids, vals, stream
    "heap_kmin_launch": [_P, _P, _I, _I, _P, _I, _P, _P, _P],
    # a, size, starts, active, K, cap, c, stream
    "heap_sift_launch": [_P, _P, _P, _P, _I, _I, _I, _P],
    # a, size, rem, m_left, K, cap, C, size_out, stream
    "heap_insert_launch": [_P, _P, _P, _P, _I, _I, _I, _P, _P],
    # body, n, eu, ev, E, valid, e_live, init, relabel, when, unless, io,
    # scratch, ctrl, max_iters, stream
    "label_prop_launch": [_I, _I, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P,
                          _P, _P, _I, _P],
    # body, n -> int32 words of scratch
    "label_prop_scratch_words": [_I, _I],
    # K, N, C, a_keys, its row stride, a_vals, stride, keep, stride,
    # b_keys, stride, b_vals, stride, b_count, out keys, stride, out vals,
    # stride, scratch, its 64-bit words, stream
    "sorted_merge_launch": [_I, _I, _I, _P, _L, _P, _L, _P, _L, _P, _L, _P,
                            _L, _P, _P, _L, _P, _L, _P, _L, _P],
    # K, N -> 64-bit words of scratch
    "sorted_merge_scratch_words": [_I, _I],
    "sorted_merge_tile": [],
    "sorted_merge_max_lanes": [],
    # q, k, v, o, B, H, K, Sq, Skv, hd, hd_v, the (batch, seq, head)
    # strides of q, k, v and o, scale, cap, causal, window, kv_len,
    # q_offset, dtype, stream
    "flash_attention_launch": [_P, _P, _P, _P] + [_I] * 7 + [_L] * 12
    + [_F, _F] + [_I] * 5 + [_P],
    # the per-token and the chunked body: r, k, v, w, u, state0, y, S_T,
    # B, S, H, hd, the (batch, seq, head) strides of r, k, v and w, dtype,
    # stream
    "rwkv6_scan_step_launch": _RWKV6,
    "rwkv6_scan_chunk_launch": _RWKV6,
    # a, b, h0, hs, h_T, B, S, R, the (batch, seq) strides of a and b,
    # stream
    "rglru_scan_launch": [_P] * 5 + [_I] * 3 + [_L] * 4 + [_P],
    "rglru_scan_smem_bytes": [],
    # r, k, v, w, u, state0, dy, dS_T, dr, dk, dv, dw, du (B, H, hd),
    # dstate0, the saved states and their f32 count, B, S, H, hd, the
    # (batch, seq, head) strides of r, k and v, dtype, stream
    "rwkv6_scan_bwd_launch": [_P] * 15 + [_L] + [_I] * 4 + [_L] * 9
    + [_I, _P],
    "rwkv6_scan_bwd_smem_bytes": [],
    # a, h0, hs, dhs, dh_T, da, db, dh0, B, S, R, stream
    "rglru_scan_bwd_launch": [_P] * 8 + [_I] * 3 + [_P],
    "rglru_scan_bwd_smem_bytes": [],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError(
        "nvcc not found (looked at $CUDA_HOME, $PATH and /usr/local/cuda): "
        "the CUDA kernels cannot be built")


def build() -> Path:
    """Compile the kernels if this source hash has no library yet; return
    the library's path.  ``build.log`` beside it keeps ``ptxas -v``'s
    register and shared-memory report."""
    out = BUILD_ROOT / _digest()
    lib = out / LIB_NAME
    if lib.exists():
        return lib
    out.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    cu = sources()
    # pid-suffixed intermediates: two processes may build the same hash
    pid = os.getpid()
    objs = [out / f"{p.stem}.{pid}.o" for p in cu]
    procs = [subprocess.Popen(
        [nvcc, *CFLAGS, "-Xptxas", "-v", "-c", str(src), "-o", str(obj)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(cu, objs)]
    logs, failed = [], []
    for src, p in zip(cu, procs):
        text, _ = p.communicate()
        logs.append(f"== {src.name} (rc {p.returncode})\n{text}")
        if p.returncode:
            failed.append(src.name)
    log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    tmp = out / f"{LIB_NAME}.{pid}.tmp"
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    tmp_log = out / f"build.log.{pid}.tmp"
    tmp_log.write_text(log)
    os.replace(tmp_log, out / "build.log")
    os.replace(tmp, lib)               # atomic: a reader sees all or nothing
    for obj in objs:
        obj.unlink()
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use, then cached)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def stream(device: torch.device) -> int:
    """Handle of the calling thread's current CUDA stream on ``device``
    (read at each call: the combiner role migrates between threads)."""
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
            device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous tensor on the CUDA ``device``
    with this dtype and shape."""
    if device.type != "cuda":
        raise ValueError(f"the kernels run on CUDA tensors, got {device}")
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
