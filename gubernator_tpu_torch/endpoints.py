"""Shared endpoint parsing for the client and the daemon config (the port
of gubernator_tpu/endpoints.py, less the unix-socket shapes that only the
GEB door and the edge bridge use; neither is ported yet).

Endpoints are 'host:port' split on the LAST colon. An IPv6 literal
('[::1]:9100', bare '::1') would silently misparse under that rule, so
it is refused loudly wherever an endpoint is parsed: hostnames and IPv4
only, as in the reference package.
"""

from __future__ import annotations

from typing import Tuple


def reject_ipv6_endpoint(spec: str, what: str) -> str:
    """Refuse an IPv6-ish endpoint loudly at parse time instead of
    misparsing it silently. Returns `spec` for chaining."""
    if "[" in spec or "]" in spec or spec.count(":") > 1:
        raise ValueError(
            f"{what} {spec!r} looks like an IPv6 literal; endpoints "
            f"must be 'host:port' with an IPv4 address or hostname "
            f"(the wire protocol splits on the last ':')"
        )
    return spec


def parse_endpoint(spec: str, what: str = "endpoint") -> Tuple[str, int]:
    """Parse 'host:port' into (host, port). An empty spec, a missing,
    empty or non-numeric port, a port outside 1..65535 and anything
    IPv6-ish raise ValueError naming `what`, never a downstream resolver
    error."""
    if not spec:
        raise ValueError(f"{what} cannot be empty")
    reject_ipv6_endpoint(spec, what)
    host, sep, port = spec.rpartition(":")
    if not sep or not host:
        raise ValueError(f"{what} {spec!r} must be 'host:port'")
    try:
        port_n = int(port)
    except ValueError:
        raise ValueError(
            f"{what} {spec!r} has a non-numeric port {port!r}"
        ) from None
    if not (0 < port_n < 65536):
        raise ValueError(f"{what} {spec!r} port must be in 1..65535")
    return host, port_n
