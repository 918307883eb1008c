"""Native code of the port, copies of the reference package's sources
built with g++ at first use (`edge_build`): the compiled serving edge
(`edge/`) and the host hasher and prep library (`guberhash.cc`, bound by
`hashlib_native`).

`load_hashlib()` is the one place that loads the library: it returns the
`hashlib_native` module, or None (logged once as a WARNING with the
compiler's output) when the library does not build or load, in which
case the callers keep to their numpy twins and the blake2b-8 slot hash.
Imports no torch: the GEB client uses it.
"""

from __future__ import annotations

import logging
import threading

log = logging.getLogger(__name__)

_hn = None
_checked = False
_lock = threading.Lock()


def load_hashlib():
    """The native hasher and prep module, built and loaded at the first
    call; None if it cannot be."""
    global _hn, _checked
    if _checked:
        return _hn
    with _lock:
        if not _checked:
            try:
                from gubernator_tpu_torch.native import hashlib_native

                _hn = hashlib_native
            except ImportError as e:
                log.warning("native hasher and prep library unavailable "
                            "(numpy prep, blake2b-8 slot hash): %s", e)
            _checked = True
    return _hn
