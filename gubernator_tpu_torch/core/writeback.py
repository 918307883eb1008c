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

The writeback ablation (the port of scripts/ablate_sweep.py's kernel)
splits the writeback into the steps whose cost it asks about, each an
exact function with its plain version, and runs on no serving path
either (cli/ablate_writeback.py times them):

- `writeback_rows(data, bkt)`: the store side alone, every touched row
  loaded and stored back plus one (so a skipped or doubled row shows);
- `writeback_deltas(out, bkt, drow)`: the delta stream alone, each run of
  equal buckets within a chunk of `krows` rows summed into out[run end];
- `writeback_full(data, bkt, drow, krows=4|8|16)`: the whole writeback at
  each chunk height (the product's writeback_add runs 8).

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
            lib.guber_writeback_add_rows.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p,
            ]
            lib.guber_writeback_add_rows.restype = ctypes.c_int
            lib.guber_ablate_rows.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
            lib.guber_ablate_rows.restype = ctypes.c_int
            lib.guber_ablate_deltas.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
            lib.guber_ablate_deltas.restype = ctypes.c_int
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


def _check(data: torch.Tensor, bkt: torch.Tensor, drow: Optional[torch.Tensor]):
    """Device, dtype, contiguity and shapes (drow None: the rows step)."""
    named = [("data", data), ("bkt", bkt)] + ([("drow", drow)] if drow is not None else [])
    if len({t.device for _, t in named}) != 1:
        raise ValueError(
            "writeback_add: tensors on different devices "
            f"({', '.join(str(t.device) for _, t in named)})"
        )
    for name, t in named:
        if t.dtype != torch.int32:
            raise TypeError(f"writeback_add: {name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"writeback_add: {name} must be contiguous")
    if data.dim() != 2 or bkt.dim() != 1 or (drow is not None and drow.dim() != 2):
        raise ValueError("writeback_add: data [buckets, W], bkt [G], drow [G, W]")
    W = data.shape[1]
    if W not in (8, 16, 32, 64, 128):
        raise ValueError(f"writeback_add: row width {W} is not ways*8, ways in 1..16")
    if drow is not None and drow.shape != (bkt.shape[0], W):
        raise ValueError(
            f"writeback_add: drow {tuple(drow.shape)} != ({bkt.shape[0]}, {W})"
        )


#: the chunk heights the ablation compiles (kRows of csrc/writeback.cu)
ABLATION_ROWS = (4, 8, 16)


def _launch(name: str, launch) -> None:
    """Run `launch(lib, stream)` on the current stream of the current
    device; a nonzero launch code raises."""
    lib = _load()
    stream = torch.cuda.current_stream().cuda_stream
    rc = launch(lib, stream)
    if rc != 0:
        raise RuntimeError(
            f"{name}: kernel launch failed: " + lib.guber_cuda_error_string(rc).decode()
        )


def _device_of(name: str, t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type


def writeback_add(
    data: torch.Tensor, bkt: torch.Tensor, drow: torch.Tensor
) -> torch.Tensor:
    """data[bkt[i]] += drow[i] in place (int32 wrap); returns data.

    CPU tensors take writeback_add_plain. CUDA tensors launch the
    csrc/writeback.cu kernel on the current stream and count the launch
    in `writeback_add.launches`; a refused launch raises."""
    _check(data, bkt, drow)
    if _device_of("writeback_add", data) == "cpu":
        return writeback_add_plain(data, bkt, drow)
    G = bkt.shape[0]
    if G == 0:
        return data
    with torch.cuda.device(data.device):
        _launch("writeback_add", lambda lib, s: lib.guber_writeback_add(
            data.data_ptr(), bkt.data_ptr(), drow.data_ptr(), G, data.shape[1],
            data.shape[0], s))
    writeback_add.launches += 1
    return data


writeback_add.launches = 0


def writeback_full(
    data: torch.Tensor, bkt: torch.Tensor, drow: torch.Tensor, krows: int = 8
) -> torch.Tensor:
    """The ablation's `full` step: writeback_add's function, launched at
    the kernel's chunk height `krows` (4, 8 or 16) through the ablation's
    own entry; returns data. CPU tensors take writeback_add_plain; CUDA
    tensors count the launch in `writeback_full.launches` (not in
    writeback_add's, which counts the paths' writebacks)."""
    _check(data, bkt, drow)
    if krows not in ABLATION_ROWS:
        raise ValueError(f"writeback_full: krows {krows} not in {ABLATION_ROWS}")
    if _device_of("writeback_full", data) == "cpu":
        return writeback_add_plain(data, bkt, drow)
    G = bkt.shape[0]
    if G == 0:
        return data
    with torch.cuda.device(data.device):
        _launch("writeback_full", lambda lib, s: lib.guber_writeback_add_rows(
            data.data_ptr(), bkt.data_ptr(), drow.data_ptr(), G, data.shape[1],
            data.shape[0], krows, s))
    writeback_full.launches += 1
    return data


writeback_full.launches = 0


def run_last(bkt: torch.Tensor) -> torch.Tensor:
    """bool[G]: whether each row is the last of its run of equal buckets
    (each touched bucket has exactly one)."""
    last = torch.ones_like(bkt, dtype=torch.bool)
    if bkt.shape[0] > 1:
        last[:-1] = bkt[1:] != bkt[:-1]
    return last


def writeback_rows_plain(data: torch.Tensor, bkt: torch.Tensor) -> torch.Tensor:
    """The plain version of the ablation's `rows` step: every touched
    store row plus one in every int32, once a bucket however often it
    repeats, in place. (The run ends add the ones, so nothing here waits
    on the device.)"""
    ones = run_last(bkt).to(data.dtype).unsqueeze(1).expand(-1, data.shape[1])
    return data.index_add_(0, bkt, ones)


def writeback_rows(data: torch.Tensor, bkt: torch.Tensor, krows: int = 8) -> torch.Tensor:
    """The ablation's `rows` step: for every run of equal buckets in the
    sorted `bkt`, load the touched store row and store it back plus one
    in every int32 (the store side of the writeback, without the delta
    stream; the +1 makes the store observable); returns data. CPU
    tensors take writeback_rows_plain; CUDA tensors launch the
    csrc/writeback.cu kernel and count it in
    `writeback_rows.launches`."""
    _check(data, bkt, None)
    if krows not in ABLATION_ROWS:
        raise ValueError(f"writeback_rows: krows {krows} not in {ABLATION_ROWS}")
    if _device_of("writeback_rows", data) == "cpu":
        return writeback_rows_plain(data, bkt)
    G = bkt.shape[0]
    if G == 0:
        return data
    with torch.cuda.device(data.device):
        _launch("writeback_rows", lambda lib, s: lib.guber_ablate_rows(
            data.data_ptr(), bkt.data_ptr(), G, data.shape[1], data.shape[0], krows, s))
    writeback_rows.launches += 1
    return data


writeback_rows.launches = 0


def run_ends(bkt: torch.Tensor, krows: int) -> torch.Tensor:
    """int64[G]: for every row, the last row of its run of equal buckets
    cut at chunks of `krows` rows (the runs the warp's segmented sum
    forms)."""
    G = bkt.shape[0]
    idx = torch.arange(G, device=bkt.device)
    last = torch.ones(G, dtype=torch.bool, device=bkt.device)
    if G > 1:
        last[:-1] = (bkt[1:] != bkt[:-1]) | ((idx[1:] % krows) == 0)
    # the nearest last row at or after each row: a reversed running min,
    # so nothing waits on the device
    at = torch.where(last, idx, G).flip(0)
    return torch.cummin(at, 0).values.flip(0)


def writeback_deltas_plain(
    out: torch.Tensor, bkt: torch.Tensor, drow: torch.Tensor, krows: int = 8
) -> torch.Tensor:
    """The plain version of the ablation's `deltas` step: a segmented
    sum, out[run end] += the run's delta rows (int32 wrap), in place."""
    return out.index_add_(0, run_ends(bkt, krows), drow)


def writeback_deltas(
    out: torch.Tensor, bkt: torch.Tensor, drow: torch.Tensor, krows: int = 8
) -> torch.Tensor:
    """The ablation's `deltas` step: read every delta row and bucket id
    and write each run of equal buckets within a chunk of `krows` rows,
    summed (int32 wrap), into out[the run's last row]; other rows of
    `out` are not written (zero them first). The store is not touched.
    CPU tensors take writeback_deltas_plain (which adds into `out`);
    CUDA tensors launch the csrc/writeback.cu kernel and count it in
    `writeback_deltas.launches`."""
    _check(out, bkt, drow)
    if out.shape != drow.shape:
        raise ValueError(f"writeback_deltas: out {tuple(out.shape)} != drow "
                         f"{tuple(drow.shape)}")
    if krows not in ABLATION_ROWS:
        raise ValueError(f"writeback_deltas: krows {krows} not in {ABLATION_ROWS}")
    if _device_of("writeback_deltas", out) == "cpu":
        return writeback_deltas_plain(out, bkt, drow, krows)
    G = bkt.shape[0]
    if G == 0:
        return out
    with torch.cuda.device(out.device):
        _launch("writeback_deltas", lambda lib, s: lib.guber_ablate_deltas(
            out.data_ptr(), bkt.data_ptr(), drow.data_ptr(), G, drow.shape[1], krows, s))
    writeback_deltas.launches += 1
    return out


writeback_deltas.launches = 0


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
    if _device_of("add_one", x) == "cpu":
        return add_one_plain(x)
    if x.numel() == 0:
        return x
    if x.data_ptr() % 16:
        raise ValueError("add_one: x must start on a 16-byte boundary")
    with torch.cuda.device(x.device):
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        _launch("add_one", lambda lib, s: lib.guber_add_one(x.data_ptr(), x.numel(),
                                                            sms, s))
    add_one.launches += 1
    return x


add_one.launches = 0
