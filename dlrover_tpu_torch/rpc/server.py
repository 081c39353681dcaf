"""Control-plane RPC server: the port of ``dlrover_tpu/rpc/server.py``.

The two verbs of the JAX module, ``get`` and ``report``, as HTTP/1.1 POSTs
to ``/get`` and ``/report`` carrying the serialized messages of
:mod:`..common.serialize`. The JAX module's default transport is gRPC; the
machines the port runs on need not have it, so only HTTP is ported and
asking for gRPC raises.
"""

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

from ..common.constants import CommsType
from ..common.log import logger
from ..common.platform import not_ported

# A connection that sends no complete request within this many seconds is
# dropped, so a stuck client never holds a server thread for good.
REQUEST_READ_TIMEOUT_S = 60.0


class _HttpHandler(BaseHTTPRequestHandler):
    servicer = None  # a master/servicer.py MasterServicer, set per server subclass
    timeout = REQUEST_READ_TIMEOUT_S

    def do_POST(self):  # noqa: N802 — http.server API
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        try:
            if self.path == "/get":
                out = self.servicer.get(body)
            elif self.path == "/report":
                out = self.servicer.report(body)
            else:
                self.send_error(404)
                return
        except Exception as e:  # noqa: BLE001
            logger.warning("http servicer error: %r", e)
            self.send_error(500, repr(e))
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)

    def log_message(self, fmt, *args):  # no per-request stderr lines
        pass


class HttpMasterServer:
    def __init__(self, servicer, port: int = 0, host: str = "0.0.0.0"):
        handler_cls = type("Handler", (_HttpHandler,), {"servicer": servicer})
        self._httpd = ThreadingHTTPServer((host, port), handler_cls)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._httpd.serve_forever, name="http-master",
                                        daemon=True)
        self._thread.start()
        logger.info("HTTP master server listening on :%s", self.port)

    def stop(self) -> None:
        # shutdown() waits for serve_forever to acknowledge: only call it
        # on a server that was started
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(10.0)
        self._httpd.server_close()


def create_master_server(servicer, service_type: str = CommsType.HTTP,
                         port: int = 0) -> Tuple[HttpMasterServer, int]:
    """Returns (server, port). Only the HTTP transport is ported."""
    if service_type != CommsType.HTTP:
        raise not_ported(f"the {service_type!r} master transport (only HTTP is)")
    server = HttpMasterServer(servicer, port)
    return server, server.port
