"""Small shared HTTP helpers (the standard library only).

The port's copy of the two helpers of `veles_tpu/http_util.py` that its
servers and its snapshot mirror use: `http_put_file` (the mirror's
uploads) and `check_shared_token` (every token-guarded endpoint: the
inference server's /predict and /rollback, the mirror store).
"""

from __future__ import annotations

import hmac
import os
import urllib.request


def http_put_file(url: str, path: str, timeout: float = 60.0,
                  content_type: str = "application/octet-stream",
                  headers=None) -> int:
    """Stream a file to `url` by PUT (Content-Length from the file; urllib
    sends a file body in chunks). Returns the response status. `headers`
    adds request headers (the mirror's shared token)."""
    with open(path, "rb") as f:
        req = urllib.request.Request(url, data=f, method="PUT")
        req.add_header("Content-Type", content_type)
        req.add_header("Content-Length", str(os.path.getsize(path)))
        for k, v in (headers or {}).items():
            req.add_header(k, v)
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            resp.read()
            return resp.status


def check_shared_token(handler, token) -> bool:
    """Constant-time shared-token check for an http.server handler: when
    `token` is set, the request must carry it in `X-Veles-Token`, or a
    403 (with an explicit empty body, which a keep-alive client needs)
    is sent and False returned."""
    if not token:
        return True
    if hmac.compare_digest(handler.headers.get("X-Veles-Token", ""), token):
        return True
    handler.send_response(403)
    handler.send_header("Content-Length", "0")
    handler.end_headers()
    return False
