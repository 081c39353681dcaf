"""Minimal JSON-over-HTTP request-handler base: the port of
``dlrover_tpu/common/http.py``.

The serving daemon (``launcher/serve.py``) answers through it: HTTP/1.1
with an explicit Content-Length on every JSON response (keep-alive stays
sound next to chunked streaming responses), and an empty or blank request
body parses as ``{}``.
"""

import json
from http.server import BaseHTTPRequestHandler
from typing import Dict

__all__ = ["JsonRequestHandler"]


class JsonRequestHandler(BaseHTTPRequestHandler):
    # HTTP/1.1: chunked transfer (streaming completions) needs it; _send
    # always sets Content-Length so keep-alive stays sound
    protocol_version = "HTTP/1.1"

    def _send(self, code: int, payload: Dict, headers=()) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _body(self) -> Dict:
        n = int(self.headers.get("Content-Length", 0) or 0)
        raw = self.rfile.read(n) if n else b""
        return json.loads(raw) if raw.strip() else {}
