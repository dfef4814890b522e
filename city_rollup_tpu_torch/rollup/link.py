"""L1 (Dogecoin/Bitcoin) link: the chain API the orchestrator uses to
discover funding transactions and broadcast the block spend.

Reference role: city_rollup_common/src/link/ (QBitcoinAPISync over a
dogecoind JSON-RPC + electrs REST pair, link_api.rs:24-80). Two
implementations, swapped behind one interface exactly like the reference
swaps its RPC client for memory fakes in tests:

- `MemoryBTCLink`: an in-memory fake chain (UTXO set + mempool + blocks) —
  the integration-test backend;
- `RpcBTCLink`: a dogecoind-compatible JSON-RPC client (sendrawtransaction
  / generatetoaddress / getrawtransaction) for real deployments.

Counterpart of the reference's ``rollup/link.py``: a copy.
"""

from __future__ import annotations

import dataclasses
import json
import urllib.request

from . import btc


class BTCLinkAPI:
    """The orchestrator-facing surface (QBitcoinAPISync twin)."""

    def send_transaction(self, tx: btc.BTCTransaction) -> bytes:
        """Broadcast; returns txid."""
        raise NotImplementedError

    def get_transaction(self, txid: bytes) -> btc.BTCTransaction:
        raise NotImplementedError

    def get_confirmed_funding_transactions(self, address: bytes
                                           ) -> list[btc.BTCTransaction]:
        """Confirmed txs paying `address` (a p2sh hash160) that are still
        unspent — the deposits + previous block spend the next block
        consumes (get_confirmed_funding_transactions_with_vout role)."""
        raise NotImplementedError

    def mine_blocks(self, n: int) -> None:
        raise NotImplementedError


@dataclasses.dataclass
class _ChainTx:
    tx: btc.BTCTransaction
    confirmed: bool = False


class MemoryBTCLink(BTCLinkAPI):
    """Fake chain: tracks txs, confirmations, and spent outpoints."""

    def __init__(self):
        self._txs: dict[bytes, _ChainTx] = {}
        self._spent: set[tuple[bytes, int]] = set()

    def send_transaction(self, tx: btc.BTCTransaction) -> bytes:
        txid = tx.txid()
        for inp in tx.inputs:
            key = (bytes(inp.hash), inp.index)
            assert key not in self._spent, "double spend"
            self._spent.add(key)
        self._txs[txid] = _ChainTx(tx=tx)
        return txid

    def get_transaction(self, txid: bytes) -> btc.BTCTransaction:
        return self._txs[bytes(txid)].tx

    def mine_blocks(self, n: int) -> None:
        for entry in self._txs.values():
            entry.confirmed = True

    def get_confirmed_funding_transactions(self, address: bytes
                                           ) -> list[btc.BTCTransaction]:
        script = btc.p2sh_script(bytes(address))
        out = []
        for txid, entry in self._txs.items():
            if not entry.confirmed:
                continue
            for vout, o in enumerate(entry.tx.outputs):
                if o.script == script and (txid, vout) not in self._spent:
                    out.append(entry.tx)
                    break
        return out

    # test conveniences
    def fund_address(self, address: bytes, value: int,
                     script_sig: bytes = b"") -> btc.BTCTransaction:
        """Create + confirm a tx paying `value` to p2sh(address)."""
        import os
        tx = btc.BTCTransaction(
            version=2,
            inputs=[btc.BTCTransactionInput(hash=os.urandom(32), index=0,
                                            script=script_sig)],
            outputs=[btc.BTCTransactionOutput(
                value=value, script=btc.p2sh_script(bytes(address)))],
            locktime=0)
        self.send_transaction(tx)
        self.mine_blocks(1)
        return tx


class RpcBTCLink(BTCLinkAPI):           # pragma: no cover — needs a node
    """dogecoind-compatible JSON-RPC client (BTCLinkRPCConfig twin)."""

    def __init__(self, url: str, user: str = "", password: str = ""):
        self.url = url
        self._auth = None
        if user:
            import base64
            self._auth = "Basic " + base64.b64encode(
                f"{user}:{password}".encode()).decode()

    def _call(self, method: str, params: list):
        body = json.dumps({"jsonrpc": "1.0", "id": "city", "method": method,
                           "params": params}).encode()
        req = urllib.request.Request(
            self.url, data=body, headers={"Content-Type": "application/json"})
        if self._auth:
            req.add_header("Authorization", self._auth)
        with urllib.request.urlopen(req, timeout=60) as resp:
            out = json.loads(resp.read())
        if out.get("error"):
            raise RuntimeError(out["error"])
        return out["result"]

    def send_transaction(self, tx: btc.BTCTransaction) -> bytes:
        return bytes.fromhex(self._call("sendrawtransaction",
                                        [tx.serialize().hex()]))[::-1]

    def get_transaction(self, txid: bytes) -> btc.BTCTransaction:
        raw = self._call("getrawtransaction", [bytes(txid)[::-1].hex()])
        return btc.BTCTransaction.parse(bytes.fromhex(raw))

    def get_confirmed_funding_transactions(self, address: bytes
                                           ) -> list[btc.BTCTransaction]:
        utxos = self._call("scantxoutset",
                           ["start",
                            [f"raw({btc.p2sh_script(address).hex()})"]])
        return [self.get_transaction(bytes.fromhex(u["txid"])[::-1])
                for u in utxos.get("unspents", [])]

    def mine_blocks(self, n: int) -> None:
        addr = self._call("getnewaddress", [])
        self._call("generatetoaddress", [n, addr])
