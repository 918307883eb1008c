"""Build of the compiled serving edge (native/edge/edge.cc).

The edge is a C++ process that takes client HTTP/1.1 JSON and gRPC,
coalesces requests across connections, and sends each batch to the
daemon's edge bridge (serve/edge_bridge.py) as one GEB frame. Its
sources are a byte-for-byte copy of the reference package's.

`build()` compiles them with g++ at first use into
`gubernator_tpu_torch/_build/guber-edge-<tag>` (keyed by a hash of the
sources and flags, so an edited source rebuilds) and returns the path.
The binary is written to a temp file and renamed, so two processes that
build at once cannot hand out a half-written binary. A failed build
raises; nothing falls back to another binary.

    python -c "from gubernator_tpu_torch.native import edge_build; print(edge_build.build())"
    <path> --listen 19592 --grpc-listen 19593 --backend /tmp/e.sock
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE_DIR = Path(__file__).resolve().parent / "edge"
SOURCES = ("edge.cc", "h2_grpc.inc", "hpack_huffman.h")
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O2", "-Wall", "-Wextra", "-std=c++17", "-pthread")

_lock = threading.Lock()


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError(
            "g++ not found (set CXX or put g++ on PATH): the edge is built "
            f"from {SOURCE_DIR} at first use"
        )
    return cxx


def build() -> Path:
    """Compile the edge into _build/ unless an up-to-date binary is there
    already; returns its path. What the compiler printed is kept beside
    it as `.log`."""
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update((SOURCE_DIR / name).read_bytes())
    out = BUILD_DIR / f"guber-edge-{h.hexdigest()[:12]}"
    with _lock:
        if out.is_file():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE_DIR / "edge.cc")],
            capture_output=True,
            text=True,
            timeout=600,
        )
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed building {SOURCE_DIR / 'edge.cc'}:\n{log}")
        out.with_name(out.name + ".log").write_text(log)
        os.replace(tmp, out)
    return out
