"""Networked proof store + job queues: the multi-process backend.

Reference role: Redis as the entire distribution fabric —
city_redis_store/src/lib.rs (PROOFS/PROOF_COUNTERS hashes, hset_nx
idempotent writes, hincr atomic counters) + the RSMQ queues of
city_rollup_worker_dispatch (SURVEY.md §2.1 rows 10-11, §2.9). The
reference's scale story is N worker processes against one Redis; here it is
N worker processes against one `StoreServer` speaking a JSON-line TCP
protocol with the same semantics:

- data plane: idempotent set-if-not-exists (`setnx`) keyed by 24-byte job
  IDs — re-executed jobs are harmless;
- counter DAG: server-side atomic `inc` (the cross-process sync point,
  lib.rs:85-89);
- queues: visibility-timeout at-least-once delivery (a worker killed
  mid-job has its message redelivered after the hidden window).

The server wraps the SAME MemoryProofStore + QueueHub the single-process
pipeline uses, so DAG semantics are identical across backends (the
reference swaps Redis for memory fakes behind one trait the same way).

Run standalone:  python -m city_rollup_tpu_torch.rollup.netstore --port 7450
(or ``python -m city_rollup_tpu_torch.cli store-server``).

Counterpart of the reference's ``rollup/netstore.py``: a copy. The wire
protocol is the contract between processes, so a port client works
against a reference server and the other way round.
"""

from __future__ import annotations

import json
import socket
import socketserver
import threading
from typing import Optional

from .job_id import JobID
from .proof_store import MemoryProofStore, QProofStore
from .queues import QueueHub


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------

class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        srv = self.server.backend            # type: ignore[attr-defined]
        for line in self.rfile:
            try:
                req = json.loads(line)
                resp = srv.handle(req)
            except Exception as e:           # noqa: BLE001 — protocol error
                resp = {"err": repr(e)}
            self.wfile.write(json.dumps(resp).encode() + b"\n")
            self.wfile.flush()


class _Backend:
    """Command dispatcher over the in-memory store + hub."""

    def __init__(self, visibility_timeout_s: float = 600.0):
        self.store = MemoryProofStore()
        self.hub = QueueHub(visibility_timeout_s)
        # client-generated dispatch ids already processed -> their mid.
        # Makes the queue 'send' op idempotent under the client's
        # auto-reconnect retry (a dispatch that was processed but whose
        # response was lost would otherwise enqueue twice). Bounded LRU.
        import collections
        self._seen_sends = collections.OrderedDict()

    def handle(self, req: dict) -> dict:
        op = req["op"]
        if op == "get":
            v = self.store.get_bytes(_jid(req["k"]))
            return {"v": v.hex() if v is not None else None}
        if op == "setnx":
            self.store.set_bytes(_jid(req["k"]), bytes.fromhex(req["v"]))
            return {"ok": True}
        if op == "inc":
            jid = _jid(req["j"]) if req.get("j") else None
            return {"n": self.store.inc_counter(_jid(req["k"]), jid)}
        if op == "goal":
            return {"n": self.store.get_goal(_jid(req["k"]))}
        if op == "next":
            return {"jobs": [j.hex()
                             for j in self.store.get_next_jobs(_jid(req["k"]))]}
        if op == "counter":
            self.store._install_counter(
                _jid(req["k"]), req["goal"],
                [_jid(h) for h in req["next"]])
            return {"ok": True}
        if op == "member":
            self.store._add_membership(_jid(req["j"]), _jid(req["c"]))
            return {"ok": True}
        if op == "members":
            return {"counters": [c.hex() for c in
                                 self.store.memberships(_jid(req["j"]))]}
        if op == "send":
            cid = req.get("cid")
            if cid is not None and cid in self._seen_sends:
                return {"mid": self._seen_sends[cid]}
            mid = self.hub.dispatch(req["topic"], bytes.fromhex(req["msg"]))
            if cid is not None:
                self._seen_sends[cid] = mid
                while len(self._seen_sends) > 1 << 16:
                    self._seen_sends.popitem(last=False)
            return {"mid": mid}
        if op == "recv":
            got = self.hub.receive(req["topic"])
            if got is None:
                return {"mid": None}
            return {"mid": got[0], "msg": got[1].hex()}
        if op == "ack":
            return {"ok": self.hub.ack(req["topic"], req["mid"])}
        if op == "dump":
            return {"dump": self.store.dump()}
        if op == "ping":
            return {"ok": True}
        raise ValueError(f"unknown op {op}")


def _jid(h: str) -> JobID:
    return JobID.from_bytes(bytes.fromhex(h))


class StoreServer:
    """Threaded TCP server; one instance is the single source of truth for
    a proving fleet (the Redis stand-in)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 visibility_timeout_s: float = 600.0):
        self.backend = _Backend(visibility_timeout_s)

        class _Srv(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._srv = _Srv((host, port), _Handler)
        self._srv.backend = self.backend     # type: ignore[attr-defined]
        self.host, self.port = self._srv.server_address

    def serve_forever(self):
        self._srv.serve_forever()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self._srv.shutdown()
        self._srv.server_close()


# ---------------------------------------------------------------------------
# Clients
# ---------------------------------------------------------------------------

class _Conn:
    """One line-oriented connection with auto-reconnect."""

    def __init__(self, host: str, port: int):
        self.host, self.port = host, port
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._rf = None

    def _connect(self):
        self._sock = socket.create_connection((self.host, self.port),
                                              timeout=30)
        self._rf = self._sock.makefile("rb")

    def call(self, req: dict) -> dict:
        with self._lock:
            for attempt in (0, 1):
                try:
                    if self._sock is None:
                        self._connect()
                    self._sock.sendall(json.dumps(req).encode() + b"\n")
                    line = self._rf.readline()
                    if not line:
                        raise ConnectionError("server closed")
                    resp = json.loads(line)
                    if "err" in resp:
                        raise RuntimeError(f"netstore: {resp['err']}")
                    return resp
                except (OSError, ConnectionError):
                    self._sock = None
                    if attempt:
                        raise
        raise ConnectionError("unreachable")


class NetProofStore(QProofStore):
    """QProofStore over the wire (RedisStore twin)."""

    def __init__(self, host: str, port: int):
        self._c = _Conn(host, port)

    def get_bytes(self, jid: JobID) -> Optional[bytes]:
        v = self._c.call({"op": "get", "k": jid.hex()})["v"]
        return bytes.fromhex(v) if v is not None else None

    def set_bytes(self, jid: JobID, data: bytes) -> None:
        self._c.call({"op": "setnx", "k": jid.hex(), "v": data.hex()})

    def inc_counter(self, counter_id: JobID,
                    job_id: JobID | None = None) -> int:
        # with job_id the server counts each (counter, job) pair once, so
        # the auto-reconnect retry below cannot double-increment
        return self._c.call({"op": "inc", "k": counter_id.hex(),
                             "j": job_id.hex() if job_id else None})["n"]

    def get_goal(self, counter_id: JobID) -> int:
        return self._c.call({"op": "goal", "k": counter_id.hex()})["n"]

    def get_next_jobs(self, counter_id: JobID) -> list[JobID]:
        return [_jid(h) for h in
                self._c.call({"op": "next", "k": counter_id.hex()})["jobs"]]

    def _install_counter(self, counter_id: JobID, goal: int,
                         next_jobs: list[JobID]) -> None:
        self._c.call({"op": "counter", "k": counter_id.hex(), "goal": goal,
                      "next": [j.hex() for j in next_jobs]})

    def _add_membership(self, jid: JobID, counter_id: JobID) -> None:
        self._c.call({"op": "member", "j": jid.hex(),
                      "c": counter_id.hex()})

    def memberships(self, jid: JobID) -> list[JobID]:
        return [_jid(h) for h in
                self._c.call({"op": "members", "j": jid.hex()})["counters"]]


class NetQueueHub:
    """QueueHub-compatible client (ProvingDispatcher/Listener twin)."""

    def __init__(self, host: str, port: int):
        self._c = _Conn(host, port)

    def dispatch(self, topic: str, msg: bytes) -> int:
        import secrets
        # unique client id makes the send idempotent across the _Conn
        # auto-reconnect retry (server dedups on it)
        return self._c.call({"op": "send", "topic": topic,
                             "msg": msg.hex(),
                             "cid": secrets.token_hex(16)})["mid"]

    def receive(self, topic: str):
        r = self._c.call({"op": "recv", "topic": topic})
        if r["mid"] is None:
            return None
        return r["mid"], bytes.fromhex(r["msg"])

    def ack(self, topic: str, mid: int) -> bool:
        return self._c.call({"op": "ack", "topic": topic,
                             "mid": mid})["ok"]


def main(argv=None):                                      # pragma: no cover
    import argparse
    ap = argparse.ArgumentParser(prog="netstore")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7450)
    ap.add_argument("--visibility-timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    srv = StoreServer(args.host, args.port, args.visibility_timeout)
    print(json.dumps({"listening": f"{srv.host}:{srv.port}"}), flush=True)
    srv.serve_forever()


if __name__ == "__main__":                                # pragma: no cover
    main()
