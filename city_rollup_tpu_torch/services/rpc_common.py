"""Minimal JSON-RPC 2.0 over HTTP: threaded server + client.

Reference role: the hyper/jsonrpsee plumbing shared by
city_rollup_core_node (handler.rs) and city_rollup_core_api (lib.rs).

Counterpart of the reference's ``services/rpc_common.py``: a copy.
"""

from __future__ import annotations

import json
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class JsonRpcError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


class JsonRpcServer:
    """Dispatches POSTed JSON-RPC requests to registered methods; unknown
    methods optionally forward to another JSON-RPC endpoint (the reference
    node proxies query methods to the API server, handler.rs:108-117)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 forward_to: str | None = None):
        self.methods: dict = {}
        self.forward_to = forward_to
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):          # quiet
                pass

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                resp = outer._dispatch(body)
                data = json.dumps(resp).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._srv = ThreadingHTTPServer((host, port), _Handler)
        self._srv.daemon_threads = True
        self.host, self.port = self._srv.server_address

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def register(self, name: str, fn):
        self.methods[name] = fn

    def method(self, name: str):
        def deco(fn):
            self.register(name, fn)
            return fn
        return deco

    def _dispatch(self, body: bytes) -> dict:
        try:
            req = json.loads(body)
            rid = req.get("id")
            name = req["method"]
            params = req.get("params", [])
        except Exception:                       # noqa: BLE001
            return {"jsonrpc": "2.0", "id": None,
                    "error": {"code": -32700, "message": "parse error"}}
        fn = self.methods.get(name)
        if fn is None:
            if self.forward_to:
                try:
                    return _raw_call(self.forward_to, body)
                except Exception as e:          # noqa: BLE001
                    return {"jsonrpc": "2.0", "id": rid,
                            "error": {"code": -32010,
                                      "message": f"forward failed: {e!r}"}}
            return {"jsonrpc": "2.0", "id": rid,
                    "error": {"code": -32601,
                              "message": f"method not found: {name}"}}
        try:
            result = fn(*params) if isinstance(params, list) else \
                fn(**params)
            return {"jsonrpc": "2.0", "id": rid, "result": result}
        except JsonRpcError as e:
            return {"jsonrpc": "2.0", "id": rid,
                    "error": {"code": e.code, "message": str(e)}}
        except Exception as e:                  # noqa: BLE001
            return {"jsonrpc": "2.0", "id": rid,
                    "error": {"code": -32000, "message": repr(e)}}

    def serve_forever(self):
        self._srv.serve_forever()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self._srv.shutdown()
        self._srv.server_close()


def _raw_call(url: str, body: bytes) -> dict:
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type":
                                          "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


_rpc_id = [0]


def rpc_call(url: str, method: str, params: list | None = None):
    """Client side: call and return result (raises on error)."""
    _rpc_id[0] += 1
    body = json.dumps({"jsonrpc": "2.0", "id": _rpc_id[0],
                       "method": method,
                       "params": params or []}).encode()
    resp = _raw_call(url, body)
    if "error" in resp and resp["error"]:
        err = resp["error"]
        raise JsonRpcError(err.get("code", -1), err.get("message", ""))
    return resp.get("result")
