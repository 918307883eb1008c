"""Builds of the port's native code, with g++ at first use.

- The compiled edge (native/edge/edge.cc): a C++ process that takes
  client HTTP/1.1 JSON and gRPC, coalesces requests across connections,
  and sends each batch to the daemon's edge bridge
  (serve/edge_bridge.py) as one GEB frame. `build()` returns the path of
  `gubernator_tpu_torch/_build/guber-edge-<tag>`.
- The host hasher and prep library (native/guberhash.cc): the XXH64
  slot hash, crc32, the presorts, the fused prep and merge.
  `build_hasher()` returns the path of
  `gubernator_tpu_torch/_build/libguberhash-<tag>.so`, which
  native/hashlib_native.py loads with ctypes.

Both sources are byte-for-byte copies of the reference package's. The
tag is a hash of the sources and flags, so an edited source rebuilds.
The output is written to a temp file and renamed, and a lock file beside
each output (`<output>.lock`) lets one process or thread compile it
while others wait for it, so builds of one output neither hand out a
half-written file nor compile it twice, and builds of different outputs
run at once. What the compiler printed is kept beside the output as
`.log`. A failed build raises with that
output; nothing falls back to another binary.

    python -c "from gubernator_tpu_torch.native import edge_build; print(edge_build.build())"
    <path> --listen 19592 --grpc-listen 19593 --backend /tmp/e.sock
    python -c "from gubernator_tpu_torch.native import edge_build; print(edge_build.build_hasher())"
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE_DIR = Path(__file__).resolve().parent / "edge"
SOURCES = ("edge.cc", "h2_grpc.inc", "hpack_huffman.h")
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O2", "-Wall", "-Wextra", "-std=c++17", "-pthread")
HASHER_SOURCE = Path(__file__).resolve().parent / "guberhash.cc"
# the reference's Makefile flags, plus <cstdio> and <cstdlib> forced in:
# the source (a byte copy) calls fprintf, getenv and atol without their
# headers, which g++ 12's libstdc++ pulls in through others and g++ 13's
# does not
HASHER_FLAGS = ("-O3", "-fPIC", "-shared", "-Wall", "-pthread",
                "-include", "cstdio", "-include", "cstdlib")


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError(
            "g++ not found (set CXX or put g++ on PATH): the port's native "
            f"code is built from {SOURCE_DIR.parent} at first use"
        )
    return cxx


def _compile(sources, flags, main: Path, stem: str, suffix: str = "") -> Path:
    """g++ `flags` `main` into BUILD_DIR/<stem>-<tag><suffix> unless that
    file is there already; returns its path."""
    h = hashlib.sha1(" ".join(flags).encode())
    for src in sources:
        h.update(Path(src).read_bytes())
    out = BUILD_DIR / f"{stem}-{h.hexdigest()[:12]}{suffix}"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # each open of the lock file is its own lock: threads of one process
    # wait for each other as processes do
    fd = os.open(out.with_name(out.name + ".lock"), os.O_RDWR | os.O_CREAT, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)  # another builder of `out` may be at work
        if out.is_file():
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_cxx(), *flags, "-o", str(tmp), str(main)],
            capture_output=True,
            text=True,
            timeout=600,
        )
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed building {main}:\n{log}")
        out.with_name(out.name + ".log").write_text(log)
        os.replace(tmp, out)
    finally:
        os.close(fd)  # releases the lock
    return out


def build() -> Path:
    """Compile the edge into _build/ unless an up-to-date binary is there
    already; returns its path."""
    return _compile([SOURCE_DIR / s for s in SOURCES], CXX_FLAGS,
                    SOURCE_DIR / "edge.cc", "guber-edge")


def build_hasher() -> Path:
    """Compile guberhash.cc into a shared library in _build/ unless an
    up-to-date one is there already; returns its path."""
    return _compile([HASHER_SOURCE], HASHER_FLAGS, HASHER_SOURCE,
                    "libguberhash", ".so")
