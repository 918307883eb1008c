"""Vendored minimal Kubernetes Endpoints client (no kubernetes package).

The reference watches the Endpoints API through client-go informers
(reference kubernetes.go:56-157). This image has no `kubernetes` python
package, so the repo vendors the one-resource slice K8sPool needs — LIST
and WATCH of v1 Endpoints with a label selector — over the plain
Kubernetes REST API via stdlib http.client (bearer token; the watch is a
line-delimited JSON event stream, chunked decoding handled by
http.client transparently).

Surface mirrors the kubernetes library's exactly where K8sPool touches
it: `api.list_namespaced_endpoints(ns, label_selector=)`,
`watch.stream(fn, ns, label_selector=)` yielding
`{"type": ..., "object": <endpoints>}` with `.subsets[].addresses[].ip`,
and `watch.stop()` — so the pool runs identically on either
implementation.

The port's copy of gubernator_tpu/serve/k8s_client.py (stdlib only).
"""

from __future__ import annotations

import http.client
import json
import logging
import ssl
import threading
import urllib.parse
from typing import Optional

log = logging.getLogger("gubernator_tpu_torch.k8s")

_SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

# bounds the stranded-thread window when stop() races a connect: the
# watch's socket itself runs with NO timeout once established
_CONNECT_TIMEOUT_S = 10.0


class _Address:
    def __init__(self, d: dict):
        self.ip = d.get("ip", "")


class _Subset:
    def __init__(self, d: dict):
        self.addresses = [_Address(a) for a in d.get("addresses") or []]


class _Endpoints:
    """Shape-compatible stand-in for V1Endpoints (the pool reads only
    .subsets[].addresses[].ip)."""

    def __init__(self, d: dict):
        self.subsets = [_Subset(s) for s in d.get("subsets") or []]
        self.metadata = d.get("metadata", {})


class _EndpointsList:
    def __init__(self, items):
        self.items = items


class VendoredK8sApi:
    def __init__(
        self,
        base_url: Optional[str] = None,
        token: Optional[str] = None,
        ca_cert: Optional[str] = None,
        timeout: float = 10.0,
    ):
        """Defaults load the in-cluster config the way client libraries
        do: KUBERNETES_SERVICE_HOST/PORT env + the mounted
        serviceaccount token/CA. Tests inject base_url (plain http)."""
        import os

        self._token_path: Optional[str] = None
        if base_url is None:
            host = os.environ.get("KUBERNETES_SERVICE_HOST")
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            if not host:
                raise RuntimeError(
                    "not in a kubernetes cluster "
                    "(KUBERNETES_SERVICE_HOST unset) and no base_url given"
                )
            base_url = f"https://{host}:{port}"
            if token is None:
                # remember the PATH, not the value: bound service-account
                # tokens rotate (~1h on modern clusters) and a stale
                # bearer would 401 every reconnect forever
                self._token_path = f"{_SA_DIR}/token"
            if ca_cert is None:
                ca_cert = f"{_SA_DIR}/ca.crt"
        self.token = token
        self.timeout = timeout
        u = urllib.parse.urlparse(base_url.rstrip("/"))
        self._host = u.hostname
        self._port = u.port or (443 if u.scheme == "https" else 80)
        self._ssl: Optional[ssl.SSLContext] = None
        if u.scheme == "https":
            self._ssl = ssl.create_default_context(cafile=ca_cert)

    # -- low-level ----------------------------------------------------------

    def _open(self, path: str, timeout: Optional[float]):
        """One GET; returns (conn, resp). `timeout=None` means a true
        no-timeout socket (watches) — the connect itself is still
        bounded so teardown never waits on an unreachable apiserver."""
        if self._ssl is not None:
            conn = http.client.HTTPSConnection(
                self._host, self._port, context=self._ssl,
                timeout=_CONNECT_TIMEOUT_S,
            )
        else:
            conn = http.client.HTTPConnection(
                self._host, self._port, timeout=_CONNECT_TIMEOUT_S
            )
        headers = {"Accept": "application/json"}
        token = self.token
        if self._token_path is not None:
            with open(self._token_path) as f:
                token = f.read().strip()  # fresh per request (rotation)
        if token:
            headers["Authorization"] = f"Bearer {token}"
        try:
            conn.request("GET", path, headers=headers)
            resp = conn.getresponse()
            # lift the connect deadline off the established socket;
            # sock.settimeout(None) is the ONLY way to get an unbounded
            # watch (a falsy-None passed through `or` defaults would
            # silently reimpose a deadline — the bug this replaces)
            conn.sock.settimeout(timeout)
        except Exception:
            conn.close()
            raise
        return conn, resp

    @staticmethod
    def _endpoints_path(namespace: str, label_selector: str,
                        watch: bool) -> str:
        q = {}
        if label_selector:
            q["labelSelector"] = label_selector
        if watch:
            q["watch"] = "true"
        qs = ("?" + urllib.parse.urlencode(q)) if q else ""
        return f"/api/v1/namespaces/{namespace}/endpoints{qs}"

    # -- kubernetes-library-compatible surface ------------------------------

    def list_namespaced_endpoints(
        self, namespace: str, label_selector: str = ""
    ) -> _EndpointsList:
        conn, resp = self._open(
            self._endpoints_path(namespace, label_selector, False),
            self.timeout,
        )
        try:
            body = resp.read()
            if resp.status != 200:
                raise RuntimeError(
                    f"endpoints list failed: HTTP {resp.status}: "
                    f"{body[:200]!r}"
                )
            doc = json.loads(body)
            return _EndpointsList(
                [_Endpoints(i) for i in doc.get("items", [])]
            )
        finally:
            conn.close()

    def open_endpoints_watch(
        self, namespace: str, label_selector: str = ""
    ):
        """EAGERLY open the watch request; returns (resp, close_fn).
        `resp` is the live http.client response (chunked decoding
        transparent; readline() yields one JSON event per line).
        Kubernetes synthesizes ADDED events for current state on an
        rv-less watch — the informer-style initial LIST the pool needs.
        close_fn is thread-safe and unblocks a parked readline()."""
        conn, resp = self._open(
            self._endpoints_path(namespace, label_selector, True), None
        )
        if resp.status != 200:
            body = resp.read(200)
            conn.close()
            raise RuntimeError(
                f"watch failed: HTTP {resp.status}: {body!r}"
            )

        def close():
            # shutdown-then-close from another thread makes a blocked
            # readline() return/raise instead of waiting forever
            try:
                import socket as _socket

                if conn.sock is not None:
                    conn.sock.shutdown(_socket.SHUT_RDWR)
            except OSError:
                pass
            conn.close()

        return resp, close


class VendoredK8sWatch:
    """kubernetes.watch.Watch-shaped wrapper over the vendored API."""

    def __init__(self):
        self._lock = threading.Lock()
        self._close = None
        self._stopped = False

    def stream(self, list_fn, namespace: str, label_selector: str = ""):
        """NOT a generator function: the watch connection opens eagerly
        HERE, before any iteration, so a stop() racing startup always
        has a socket to close (a lazy generator would park the worker
        thread in a long-poll nothing can reach)."""
        # list_fn is the bound api.list_namespaced_endpoints — recover
        # the api object the way the kubernetes library dispatches on
        # the function identity
        api: VendoredK8sApi = list_fn.__self__
        with self._lock:
            if self._stopped:
                return iter(())
        resp, close = api.open_endpoints_watch(
            namespace, label_selector=label_selector
        )
        with self._lock:
            self._close = close
            if self._stopped:  # stop() landed during the connect
                close()
                return iter(())

        def events():
            try:
                while True:
                    try:
                        raw = resp.readline()
                    except (
                        OSError,
                        ValueError,
                        AttributeError,  # resp.fp=None after conn.close()
                        http.client.HTTPException,
                    ):
                        return  # closed underneath us (stop())
                    if not raw:
                        return
                    if not raw.strip():
                        continue
                    try:
                        ev = json.loads(raw)
                    except ValueError:
                        log.warning(
                            "k8s watch: undecodable event line; skipping"
                        )
                        continue
                    with self._lock:
                        if self._stopped:
                            return
                    if ev.get("type") == "ERROR":
                        # a Status object, not Endpoints (expired watch,
                        # internal error). The kubernetes library raises
                        # here too: yielding it would push an EMPTY peer
                        # list and un-own every key until the next real
                        # event. Raising routes into the pool's
                        # retry/relist path instead.
                        raise RuntimeError(
                            "k8s watch ERROR event: "
                            f"{ev.get('object', {})!r}"
                        )
                    yield {
                        "type": ev.get("type", ""),
                        "object": _Endpoints(ev.get("object", {})),
                    }
            finally:
                close()

        return events()

    def stop(self):
        with self._lock:
            self._stopped = True
            close = self._close
        if close is not None:
            close()
