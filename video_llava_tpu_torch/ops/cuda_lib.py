"""Build, load and launch the port's CUDA kernels.

Each source under ``video_llava_tpu_torch/csrc`` compiles with its own
``nvcc`` process, all started together, and the objects link into one
shared library with a plain C interface, bound with ctypes. Without
PyTorch's headers the build takes seconds. The library is built
at first use into ``video_llava_tpu_torch/build/`` under a name that
hashes the sources and flags, so an edited source rebuilds and nothing
stale is loaded. ``ptxas -v`` output (registers, shared memory, spills
per kernel) is kept beside it as ``<name>.log``.

Every C entry point launches on the stream it is given, allocates
nothing and returns ``cudaGetLastError()``; :func:`launch` raises when
that is not 0 and counts the launch in :data:`LAUNCHES` otherwise.
"""

from __future__ import annotations

import collections
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# kernel name -> successful launches since the last reset_launch_counts()
LAUNCHES: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every entry point (all return int: a cudaError_t).
_SIGNATURES = {
    # q, k, v, out; bh, s, d, kv_len; scale
    "vlt_flash_bhsd": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    "vlt_flash_bhsd_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    # x, out, partial, nvalid (or null); b, t, s, c, T, n, denom, out_bf16
    "vlt_spatio_temporal_pool": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                 _I, _P),
    "vlt_pool_rows_per_block": (),
    # q, k, v, ks, vs, lengths, o, ws, counters; layer, b, L, h, d, int8,
    # chunk, splits; scale
    "vlt_decode_attention": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
        _F, _P,
    ),
    # q, k, v, ks, vs, table, lengths, o, ws; layer, b, nblocks, bs, maxb,
    # h, d, int8, chunk, splits; scale
    "vlt_decode_attention_paged": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
        _I, _I, _F, _P,
    ),
    # q, k, v, ks, vs, lengths, o, ws; b, L, h, h_kv, d, int8, chunk,
    # splits; scale
    "vlt_decode_attention_gqa": (
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
        _P,
    ),
    # x, packed, scales, out, partial; nb, dh, f, n_groups, rows, out_bf16
    "vlt_w4a8_matvec": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # x, packed, scales, out, partial; dh, f, n_groups, rows, out_bf16
    "vlt_w4a16_matvec": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # x, packed, scales, out, partial; nb, dh, f, n_groups, rows_tile,
    # stages, rows_per_split, out_bf16
    "vlt_w4a16_block": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                        _P),
    # x, packed, scales, xq, sx, out, partial; nb, dh, f, n_groups,
    # rows_tile, rows_per_split, out_bf16
    "vlt_w4a8_block": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _I, _P),
    # q, k, v, out, lse; b, sq, skv, h, h_kv, d, causal; scale
    "vlt_flash_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                      _P),
    "vlt_flash_fwd_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _F, _P),
    # q, k, v, dout, lse, delta, dq; the same shape arguments
    "vlt_flash_bwd_dq": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _I, _F, _P),
    # q, k, v, dout, lse, delta, dk, dv; the same shape arguments
    "vlt_flash_bwd_dkv": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _I, _F, _P),
    "vlt_flash_bwd_dq_f32": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _I, _F, _P),
    "vlt_flash_bwd_dkv_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, _I, _I, _F, _P),
    # value, locs, weights, out; b, sum_hw, q, nh, hd, L, P; host (h, w)
    # ints; bf16
    "vlt_msda": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P),
}

_lib = None
_lock = threading.Lock()
_count_lock = threading.Lock()
_counters: dict = {}  # device index -> int32 arrival counters, all 0


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def _sources():
    return sorted(
        glob.glob(os.path.join(CSRC_DIR, "*.cu"))
        + glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    )


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is required "
                           "to build the kernels")
    return path


def build() -> str:
    """Compile csrc/ into the shared library (if not built yet) and
    return its path."""
    sources = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    out = os.path.join(BUILD_DIR, f"libvlt_kernels_{h.hexdigest()[:12]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    cu = [s for s in sources if s.endswith(".cu")]
    objs, procs = [], []
    for src in cu:
        obj = f"{tmp}.{os.path.basename(src)}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate()[0] for p in procs]  # every build runs to its end
    failed = [(src, log) for src, log, p in zip(cu, logs, procs)
              if p.returncode != 0]
    link = None
    if not failed:
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp,
                               *objs], capture_output=True, text=True)
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed or link.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{src}:\n{log}" for src, log in failed) + (
                "" if link is None else link.stdout + link.stderr))
    with open(out[:-3] + ".log", "w") as f:
        f.write("".join(logs) + link.stdout + link.stderr)
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.vlt_error_string.argtypes = [ctypes.c_int]
            lib.vlt_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def launch(kernel: str, entry: str, device: torch.device, *args) -> None:
    """Call C entry point `entry` on `device`'s current stream (appended
    as the last argument), raise on a CUDA error, count one launch of
    `kernel`."""
    lib = library()
    with torch.cuda.device(device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
        rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        raise RuntimeError(
            f"{kernel}: CUDA error {rc}: {lib.vlt_error_string(rc).decode()}"
        )
    with _count_lock:  # serving launches from its engine and HTTP threads
        LAUNCHES[kernel] += 1


def counters(device: torch.device, n: int) -> torch.Tensor:
    """At least `n` int32 arrival counters at 0 on `device`, for the
    kernels whose last block to finish merges the split partials (kernels
    3 and 9). Each launch leaves the counters it used at 0, so one buffer
    a device serves every launch in stream order (not launches that run
    at once on two streams). Zeroed when first made or grown, never per
    call: a memset would be a launch of its own. Growing it inside a CUDA
    graph capture raises (call once before capturing)."""
    with _lock:
        buf = _counters.get(device.index)
        if buf is None or buf.numel() < n:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("arrival counters grown during a CUDA "
                                   "graph capture: launch once before it")
            size = max(n, 4096, 0 if buf is None else 2 * buf.numel())
            buf = torch.zeros(size, dtype=torch.int32, device=device)
            _counters[device.index] = buf
    return buf


def require(t: torch.Tensor, name: str, dtype, shape=None,
            device=None) -> None:
    """Raise unless `t` is a contiguous CUDA tensor (on `device` when
    given) of `dtype` (and `shape`), 16-byte aligned, as every kernel
    reads it."""
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{name}: expected a tensor on "
                         f"{device or 'a CUDA device'}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")
