"""Shared endpoint parsing for every client and door (the port's copy
of gubernator_tpu/endpoints.py).

The GEB frame protocol and the bridge/daemon config carry endpoints as
'host:port' split on the LAST colon, or a unix-socket path. An IPv6
literal ('[::1]:9100', bare '::1') would silently misparse under that
rule, so it is refused loudly wherever an endpoint is parsed: hostnames
and IPv4 only, as in the reference package. Dependency-free: the
packaged clients import it.
"""

from __future__ import annotations

from typing import Tuple, Union


def endpoint_is_ipv6ish(spec: str) -> bool:
    """True when `spec` looks like an IPv6 literal — the shapes the
    last-colon split would silently misparse (r7's rule, mirrored from
    edge.cc endpoint_is_ipv6ish)."""
    return "[" in spec or "]" in spec or spec.count(":") > 1


def reject_ipv6_endpoint(spec: str, what: str) -> str:
    """Refuse an IPv6-ish endpoint loudly at parse time instead of
    misparsing it silently. Returns `spec` for
    chaining."""
    if endpoint_is_ipv6ish(spec):
        raise ValueError(
            f"{what} {spec!r} looks like an IPv6 literal; endpoints "
            f"must be 'host:port' with an IPv4 address or hostname "
            f"(the wire protocol splits on the last ':')"
        )
    return spec


def parse_endpoint(
    spec: str, what: str = "endpoint"
) -> Tuple[str, Union[str, Tuple[str, int]]]:
    """Parse one endpoint spec into ('unix', path) or
    ('tcp', (host, port)).

    Accepted shapes:
      'host:port'            TCP (IPv4 address or hostname only)
      '/path/to.sock'        unix socket (absolute path)
      'unix:/path/to.sock'   unix socket, explicit scheme

    Anything IPv6-ish is refused loudly (see endpoint_is_ipv6ish); a
    TCP spec with a missing/empty/non-numeric port raises ValueError
    naming `what`, never a downstream resolver error.
    """
    if not spec:
        raise ValueError(f"{what} cannot be empty")
    if spec.startswith("unix:"):
        path = spec[len("unix:"):]
        if not path:
            raise ValueError(f"{what} {spec!r} has an empty unix path")
        return ("unix", path)
    if spec.startswith("/"):
        return ("unix", spec)
    reject_ipv6_endpoint(spec, what)
    host, sep, port = spec.rpartition(":")
    if not sep or not host:
        raise ValueError(
            f"{what} {spec!r} must be 'host:port' or a unix socket path"
        )
    try:
        port_n = int(port)
    except ValueError:
        raise ValueError(
            f"{what} {spec!r} has a non-numeric port {port!r}"
        ) from None
    if not (0 < port_n < 65536):
        raise ValueError(
            f"{what} {spec!r} port must be in 1..65535"
        )
    return ("tcp", (host, port_n))
