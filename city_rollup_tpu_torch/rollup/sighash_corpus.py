"""Sighash whitelist corpus: offline fingerprint precomputation + fixture.

Reference role: `city_rollup_common/src/config/sighash_wrapper_config.rs:24`
pins all 1,875 whitelisted sighash circuit fingerprints as compile-time
constants — workers never rebuild the whole family; they load the pinned
list, build the whitelist tree over it (`city_store/src/store/sighash/
mod.rs:24-85`), and lazily build only the shape circuits they actually
prove (`sighash_wrapper.rs:58,129-160` caches per config).

This module is the TPU build's equivalent of the offline precompute that
produced that Rust constant table:

  * `derive_shared_shape` probes a few shapes once and records the union
    gate set + degree every minifier is padded onto (so later builds skip
    the probe pass, one of the two minifier builds a shape costs);
  * `generate` computes fingerprints for any slice of the 1,875-id
    enumeration, resumably appending to a JSON fixture;
  * `SigHashCorpus` loads the fixture and hands `SigHashToolbox` the full
    whitelist (tree over every pinned fingerprint) while circuits build
    lazily per proved shape, each build asserting its fingerprint matches
    the pinned entry.

Fingerprints are deployment-specific (the covenant script body — which
embeds the Groth16 verifier-data chunks — and the spend config are baked
into each circuit as constants), so the fixture records both plus the
CircuitConfig key, and loading cross-checks them. Every shape is a full
build (its accelerator, its circuit, its minifier), so the full
1,875-entry corpus is a long offline job (`cli.py sighash-corpus` shards
it with --start/--count).

Counterpart of the reference's ``rollup/sighash_corpus.py``; the shape
circuits and minifiers it builds run on the given ``device``.
"""

from __future__ import annotations

import dataclasses
import json
import os

from ..snark.circuit import common_shape_key
from ..snark.minifier import ProofMinifier
from . import btc
from .sighash_circuit import SigHashCircuit, SigHashShape


def _config_key(config) -> str:
    return json.dumps(dataclasses.asdict(config), sort_keys=True, default=str)


def _spend_cfg_dict(cfg: btc.BlockSpendCoreConfig) -> dict:
    return dataclasses.asdict(cfg)


@dataclasses.dataclass
class SigHashCorpus:
    """A (possibly partial) fingerprint corpus + the shared minified shape
    descriptor all entries were built against."""
    config_key: str
    spend_cfg: btc.BlockSpendCoreConfig
    script_body: bytes
    gate_keys: list[str]
    log_d: int
    fps: dict                       # gid_felt -> (f0, f1, f2, f3)

    # -- fixture IO ----------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "config_key": self.config_key,
            "spend_cfg": _spend_cfg_dict(self.spend_cfg),
            "script_body": self.script_body.hex(),
            "gate_keys": self.gate_keys,
            "log_d": self.log_d,
            "fps": {hex(k): [str(x) for x in v]
                    for k, v in sorted(self.fps.items())},
        }, indent=0)

    @classmethod
    def from_json(cls, text: str) -> "SigHashCorpus":
        d = json.loads(text)
        return cls(
            config_key=d["config_key"],
            spend_cfg=btc.BlockSpendCoreConfig(**d["spend_cfg"]),
            script_body=bytes.fromhex(d["script_body"]),
            gate_keys=list(d["gate_keys"]),
            log_d=int(d["log_d"]),
            fps={int(k, 16): tuple(int(x) for x in v)
                 for k, v in d["fps"].items()})

    @classmethod
    def load(cls, path: str) -> "SigHashCorpus":
        with open(path) as f:
            return cls.from_json(f.read())

    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.to_json())
        os.replace(tmp, path)

    # -- derived -------------------------------------------------------------
    def gates(self) -> list:
        from ..snark.gates import gate_from_key
        return [gate_from_key(k) for k in self.gate_keys]

    def whitelist_root(self):
        from .sighash_tree import SigHashMerkleTree
        return SigHashMerkleTree.build(
            [self.fps[k] for k in sorted(self.fps)]).root


def derive_shared_shape(config, spend_cfg, script_body,
                        probe_gids=None, device=None
                        ) -> tuple[list[str], int]:
    """Probe a few extreme shapes to fix the declared gate set + degree the
    whole family pads onto. The probes must include the largest layout
    (max deposits/withdrawals both current and last block) — every other
    shape's minifier is a subset padded up to it."""
    if probe_gids is None:
        probe_gids = [
            btc.SigHashGadgetId(0, 0, 0, 0, 0),
            btc.SigHashGadgetId(4, 4, 4, 4, 4),
        ]
    gate_objs: dict = {}
    log_d = 0
    for gid in probe_gids:
        circ = SigHashCircuit.build(
            config, SigHashShape(gid=gid, cfg=spend_cfg), script_body,
            device=device)
        probe = ProofMinifier.build(circ.data, config, device=device)
        for g in probe.data.common.gates:
            gate_objs.setdefault(g.key, g)
        log_d = max(log_d, probe.data.common.log_n)
    return sorted(gate_objs), log_d


def build_entry(config, corpus: SigHashCorpus, gid: btc.SigHashGadgetId,
                expect_shape_key=None, device=None):
    """Build one shape circuit + its shared-shape minifier, both for
    `device`; returns (BuiltSigHashShape-compatible tuple): (circuit,
    minifier)."""
    circ = SigHashCircuit.build(
        config, SigHashShape(gid=gid, cfg=corpus.spend_cfg),
        corpus.script_body, device=device)
    mini = ProofMinifier.build(circ.data, config,
                               declared_gates=corpus.gates(),
                               min_log_n=corpus.log_d, device=device)
    if expect_shape_key is not None:
        assert common_shape_key(mini.data.common) == expect_shape_key, \
            f"sighash shape {gid} diverged from the shared minified shape"
    return circ, mini


def generate(config, spend_cfg, script_body, out_path: str,
             start: int = 0, count: int | None = None,
             max_deposits: int = 4, max_withdrawals: int = 4,
             progress=None, device=None) -> SigHashCorpus:
    """Resumable corpus generation over the canonical id enumeration.

    Loads `out_path` if present (asserting identical config/spend/body),
    computes missing fingerprints for ids [start, start+count), and saves
    after every entry (a killed run loses at most one shape's work).
    """
    ids = btc.generate_id_permutations(max_deposits, max_withdrawals)
    ck = _config_key(config)
    if os.path.exists(out_path):
        corpus = SigHashCorpus.load(out_path)
        assert corpus.config_key == ck, "fixture built for a different config"
        assert corpus.spend_cfg == spend_cfg
        assert corpus.script_body == script_body
    else:
        gate_keys, log_d = derive_shared_shape(config, spend_cfg,
                                               script_body, device=device)
        corpus = SigHashCorpus(config_key=ck, spend_cfg=spend_cfg,
                               script_body=script_body,
                               gate_keys=gate_keys, log_d=log_d, fps={})
        corpus.save(out_path)
    end = len(ids) if count is None else min(len(ids), start + count)
    for i in range(start, end):
        gid = ids[i]
        felt = gid.to_felt()
        if felt in corpus.fps:
            continue
        _, mini = build_entry(config, corpus, gid, device=device)
        corpus.fps[felt] = tuple(int(x) for x in mini.fingerprint)
        corpus.save(out_path)
        if progress:
            progress(i, len(ids), gid, corpus.fps[felt])
    return corpus
