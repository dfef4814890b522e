"""User signature-proving service — the reference's
city_rollup_user_prover_api (src/api/mod.rs:19-52, src/run.rs:18-51): a
JSON-RPC service that proves user signatures off the client's critical
path. Jobs enter an in-memory store and a background worker thread proves
them; clients poll for the finished proof.

Methods:
- cr_getZkPublicKey(sk4)           -> pk (4 felts)
- cr_proveZkSignature(sk4, action) -> job id (hex)
- cr_proveSecp256k1Signature(pk33_hex, msg_hex, sig_hex) -> job id
- cr_getProof(job_id)              -> {status, proof?} (encoded hex)

Counterpart of the reference's ``services/user_prover.py``: a copy. The
wrapper it is given was built for a device (``ZKSignatureWrapperCircuit.
build(..., device=)``); its proofs run there, in the worker thread.
"""

from __future__ import annotations

import hashlib
import queue
import threading

from ..rollup.circuits import encode_proof
from ..rollup.zk_signature import derive_public_key
from .rpc_common import JsonRpcError, JsonRpcServer


class UserProverWorker:
    """Background prover thread over a job queue (UserProverWorker twin)."""

    def __init__(self, zk_wrapper, l1_chain=None):
        """`zk_wrapper`: ZKSignatureWrapperCircuit; `l1_chain`: optional
        Secp256K1ProverChain for L1 (ECDSA) signature proofs."""
        self.zk_wrapper = zk_wrapper
        self.l1_chain = l1_chain
        self.jobs: dict[str, dict] = {}
        self._q: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, kind: str, payload: dict) -> str:
        jid = hashlib.sha256(repr((kind, sorted(payload.items())))
                             .encode()).hexdigest()[:24]
        with self._lock:
            if jid not in self.jobs:
                self.jobs[jid] = {"status": "pending"}
                self._q.put((jid, kind, payload))
        return jid

    def status(self, jid: str) -> dict:
        with self._lock:
            job = self.jobs.get(jid)
            return dict(job) if job else {"status": "unknown"}

    def _run(self):
        while True:
            jid, kind, payload = self._q.get()
            try:
                if kind == "zk":
                    proof = self.zk_wrapper.sign(payload["sk"],
                                                 payload["action"])
                elif kind == "secp256k1":
                    assert self.l1_chain is not None, \
                        "service built without the L1 signature circuit"
                    proof = self.l1_chain.prove(payload["pk"],
                                                payload["msg"],
                                                payload["sig"])
                else:
                    raise ValueError(kind)
                result = {"status": "done",
                          "proof": encode_proof(proof).hex()}
            except Exception as e:              # noqa: BLE001
                result = {"status": "error", "error": repr(e)}
            with self._lock:
                self.jobs[jid] = result


def make_user_prover_server(zk_wrapper, l1_chain=None,
                            host: str = "127.0.0.1", port: int = 0
                            ) -> JsonRpcServer:
    srv = JsonRpcServer(host, port)
    worker = UserProverWorker(zk_wrapper, l1_chain)
    srv.worker = worker                         # for tests / shutdown

    @srv.method("cr_getZkPublicKey")
    def get_zk_public_key(sk):
        if len(sk) != 4:
            raise JsonRpcError(-32602, "sk must be 4 felts")
        return [int(x) for x in derive_public_key([int(v) for v in sk])]

    @srv.method("cr_proveZkSignature")
    def prove_zk_signature(sk, action):
        if len(sk) != 4 or len(action) != 4:
            raise JsonRpcError(-32602, "sk and action must be 4 felts")
        return worker.submit("zk", {"sk": [int(x) for x in sk],
                                    "action": [int(x) for x in action]})

    @srv.method("cr_proveSecp256k1Signature")
    def prove_secp(pk_hex, msg_hex, sig_hex):
        from ..crypto import secp256k1 as secp
        pk = secp.ECDSAPublicKey.from_bytes_compressed(
            bytes.fromhex(pk_hex))
        msg = int(msg_hex, 16)
        raw = bytes.fromhex(sig_hex)
        sig = secp.ECDSASignature(r=int.from_bytes(raw[:32], "big"),
                                  s=int.from_bytes(raw[32:], "big"))
        return worker.submit("secp256k1", {"pk": pk, "msg": msg,
                                           "sig": sig})

    @srv.method("cr_getProof")
    def get_proof(jid):
        return worker.status(jid)

    return srv
