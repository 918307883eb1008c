"""Store writeback: the port's counterpart of core/pallas_sweep.py.

`writeback_add(data, bkt, drow)` adds every delta row drow[i] into store
row data[bkt[i]] in place, in int32 with two's-complement wrap: the last
step of every decide (kernels._writeback_apply). On a CUDA tensor it
launches the hand-written Hopper kernel in csrc/writeback.cu (the source
note there says what it replaces and how it is designed); on a CPU
tensor it runs `writeback_add_plain`, the plain PyTorch version that the
CPU tests hold against the JAX package. There is no fallback between
the two: a CUDA call launches the kernel or raises.

`add_one(x)` is the copy floor beside it (x += 1 in place, one read and
one write of every int32; plain version `x.add_(1)`): the port of the
identity sweep in scripts/bench_hbm.py, which measures the least time a
pass over the store can take. It runs on no serving path; chip_smoke.py
times it to give the writeback's bound a measured floor.

The kernel is compiled with nvcc at first use into a shared library with
a C interface under `gubernator_tpu_torch/_build/` (keyed by a hash of
the source and flags) and loaded with ctypes. Nothing is imported or
built when this module is imported.

Preconditions, checked where cheap and documented where not (as the TPU
kernel's `_apply_inline` documents its own): `bkt` is sorted
non-decreasing and in range. The wrapper checks device, dtype,
contiguity and shapes; sortedness is the caller's contract (the decide's
group stream is bucket-sorted by construction) because checking it on
the card would cost a device-to-host sync per batch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "writeback.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME", ""),
        "/usr/local/cuda",
    ):
        p = Path(cand) / "bin" / "nvcc"
        if cand and p.is_file():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the writeback kernel is built from "
            f"{SOURCE} at first use"
        )
    return found


def build() -> Path:
    """Compile csrc/writeback.cu into _build/ unless an up-to-date
    library is there already; returns the library's path. What nvcc and
    ptxas printed (registers, spills) is kept beside it as `.log`."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libguber_writeback-{tag}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True,
        text=True,
        timeout=600,
    )
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed building {SOURCE}:\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.guber_writeback_add.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
            lib.guber_writeback_add.restype = ctypes.c_int
            lib.guber_add_one.argtypes = [
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_void_p,
            ]
            lib.guber_add_one.restype = ctypes.c_int
            lib.guber_cuda_error_string.argtypes = [ctypes.c_int]
            lib.guber_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def writeback_add_plain(
    data: torch.Tensor, bkt: torch.Tensor, drow: torch.Tensor
) -> torch.Tensor:
    """The plain PyTorch version: data[bkt[i]] += drow[i], in place."""
    return data.index_add_(0, bkt, drow)


def _check(data: torch.Tensor, bkt: torch.Tensor, drow: torch.Tensor):
    if not (data.device == bkt.device == drow.device):
        raise ValueError(
            f"writeback_add: tensors on different devices "
            f"({data.device}, {bkt.device}, {drow.device})"
        )
    for name, t in (("data", data), ("bkt", bkt), ("drow", drow)):
        if t.dtype != torch.int32:
            raise TypeError(f"writeback_add: {name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"writeback_add: {name} must be contiguous")
    if data.dim() != 2 or drow.dim() != 2 or bkt.dim() != 1:
        raise ValueError("writeback_add: data [buckets, W], bkt [G], drow [G, W]")
    W = data.shape[1]
    if W not in (8, 16, 32, 64, 128):
        raise ValueError(f"writeback_add: row width {W} is not ways*8, ways in 1..16")
    if drow.shape != (bkt.shape[0], W):
        raise ValueError(
            f"writeback_add: drow {tuple(drow.shape)} != ({bkt.shape[0]}, {W})"
        )


def writeback_add(
    data: torch.Tensor, bkt: torch.Tensor, drow: torch.Tensor
) -> torch.Tensor:
    """data[bkt[i]] += drow[i] in place (int32 wrap); returns data.

    CPU tensors take writeback_add_plain. CUDA tensors launch the
    csrc/writeback.cu kernel on the current stream and count the launch
    in `writeback_add.launches`; a refused launch raises."""
    _check(data, bkt, drow)
    if data.device.type == "cpu":
        return writeback_add_plain(data, bkt, drow)
    if data.device.type != "cuda":
        raise ValueError(f"writeback_add: unsupported device {data.device}")
    G = bkt.shape[0]
    if G == 0:
        return data
    lib = _load()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        rc = lib.guber_writeback_add(
            data.data_ptr(), bkt.data_ptr(), drow.data_ptr(),
            G, data.shape[1], data.shape[0], stream,
        )
    if rc != 0:
        raise RuntimeError(
            "writeback_add: kernel launch failed: "
            + lib.guber_cuda_error_string(rc).decode()
        )
    writeback_add.launches += 1
    return data


writeback_add.launches = 0


def add_one_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: x += 1, in place."""
    return x.add_(1)


def add_one(x: torch.Tensor) -> torch.Tensor:
    """x += 1 in place over a contiguous int32 tensor (int32 wrap);
    returns x. CPU tensors take add_one_plain; CUDA tensors launch the
    copy-floor kernel of csrc/writeback.cu on the current stream and
    count the launch in `add_one.launches`; a refused launch raises."""
    if x.dtype != torch.int32:
        raise TypeError(f"add_one: x must be int32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("add_one: x must be contiguous")
    if x.device.type == "cpu":
        return add_one_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"add_one: unsupported device {x.device}")
    if x.numel() == 0:
        return x
    if x.data_ptr() % 16:
        raise ValueError("add_one: x must start on a 16-byte boundary")
    lib = _load()
    with torch.cuda.device(x.device):
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.guber_add_one(x.data_ptr(), x.numel(), sms, stream)
    if rc != 0:
        raise RuntimeError(
            "add_one: kernel launch failed: "
            + lib.guber_cuda_error_string(rc).decode()
        )
    add_one.launches += 1
    return x


add_one.launches = 0
