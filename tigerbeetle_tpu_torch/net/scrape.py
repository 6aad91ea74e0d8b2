"""Minimal raw-socket HTTP GET for the observability scrape surface.

One implementation for every scraper of tracer.serve_metrics endpoints
(/metrics /trace /lifecycle /cluster): `cli benchmark`, the
load harness's audit and chip_smoke.py's front-door phase. Stdlib only
(socket + json): a scraper needs neither numpy nor torch.
"""

from __future__ import annotations

import json
import socket


def http_get_text(port: int, path: str, timeout: float = 10.0,
                  host: str = "127.0.0.1") -> str:
    """GET and return the body as text; IOError on any non-200."""
    with socket.create_connection((host, port), timeout=timeout) as s:
        s.settimeout(timeout)
        s.sendall(
            f"GET {path} HTTP/1.1\r\nHost: scrape\r\n"
            "Connection: close\r\n\r\n".encode()
        )
        buf = b""
        while True:
            chunk = s.recv(1 << 16)
            if not chunk:
                break
            buf += chunk
    head, _, body = buf.partition(b"\r\n\r\n")
    if not head.startswith(b"HTTP/1.1 200"):
        # head may be EMPTY (closed before any bytes): no indexing.
        raise IOError(f"scrape :{port}{path}: {head[:64]!r}")
    return body.decode("utf-8", "replace")


def http_get_json(port: int, path: str, timeout: float = 10.0,
                  host: str = "127.0.0.1"):
    return json.loads(http_get_text(port, path, timeout, host))
