"""The check that decides a run's ``correct``: the plain reference's
reading of the proofs a run wrote.

The reference is this folder: a frozen copy of the program's host code
(circuit builder, rollup circuits, state store, planner, verifier) with
every kernel replaced by its plain PyTorch version. It imports nothing of
the program. From the configuration and the traffic's plain requests it
works out again what the program's set-up derived:

1. the shape family's circuits and their verifier data (the constants
   and sigmas committed with the plain LDE and the plain Merkle tree),
   hence each circuit's fingerprint and the family's allowed root;
2. the blocks' plans: for every leaf job, the state transition its proof
   must state.

Then, for every job the worker popped: its proof is in the store
(``jobs_unproven``), and its public inputs are the allowed root, the
transition's hash and, for shape B, its events (``pi_mismatches``). A
sample of the window's proofs, drawn from the seed with every circuit
type and every place in a batch that the window holds, is verified in
full against the reference's verifier data: the commitments' caps, the
openings at zeta and FRI (``proofs_rejected``). Each of these is an exact
comparison, so each limit is 0.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import random
from pathlib import Path

from . import convert
from .core import fri
from .rollup import circuits, op_circuits, orchestrator
from .rollup.city_store import CityStore
from .rollup.job_id import JobID
from .rollup.proof_store import MemoryProofStore
from .rollup.treeprover import AggStateTransition
from .snark import verifier
from .snark.config import CircuitConfig


def params(cfg: dict):
    cc = dict(cfg["circuit_config"])
    f = fri.FriConfig(**cc.pop("fri"))
    return op_circuits.RollupParams(config=CircuitConfig(fri=f, **cc),
                                    **cfg["rollup_params"])


def _derive(cfg: dict, device) -> dict:
    """The shape family's common data, each leaf job type's (family name,
    verifier data) and each family name's allowed root."""
    tb = circuits.CircuitToolbox(params(cfg), device=device)
    fam = tb.family_a if cfg["family"] == "A" else tb.family_b
    members, allowed = {}, {}
    for name, built in fam.leaves.items():
        allowed[name] = tuple(tb.allowed_root(name))
        members[int(orchestrator.OP_CT[name])] = (name, built.data.verifier)
        members[int(orchestrator.DUMMY_CT[name])] = (name,
                                                     fam.dummy.data.verifier)
    return {"common": fam.common, "members": members, "allowed": allowed}


def family(cfg: dict, device, cache: dict, cache_dir: Path | None = None
           ) -> dict:
    """`_derive`'s result, kept in `cache` for the process and, given
    `cache_dir`, in a file there for later runs in the same checkout (the
    family build takes tens of seconds of host time)."""
    key = ("reference", cfg["name"], str(device))
    if key in cache:
        return cache[key]
    path = None
    if cache_dir is not None:
        digest = hashlib.sha256(json.dumps(cfg, sort_keys=True).encode())
        path = cache_dir / f"{cfg['name']}-{digest.hexdigest()[:16]}.pkl"
        if path.exists():
            with open(path, "rb") as f:
                cache[key] = pickle.load(f)
            return cache[key]
    derived = _derive(cfg, device)
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        with open(tmp, "wb") as f:
            pickle.dump(derived, f)
        os.replace(tmp, path)
    cache[key] = derived
    return derived


def expected_transitions(cfg: dict, plain: dict, last_checkpoint: int
                         ) -> dict:
    """{leaf job hex: AggStateTransition} from the reference's own plan of
    the traffic's blocks, up to `last_checkpoint`."""
    from portbench import traffic
    p = params(cfg)
    city = CityStore(user_tree_height=p.user_tree_height,
                     deposit_tree_height=p.deposit_tree_height,
                     withdrawal_tree_height=p.withdrawal_tree_height)
    store = MemoryProofStore()
    orch = orchestrator.Orchestrator(city, store, params=p)
    traffic.apply_genesis(city, plain["genesis"])
    out = {}
    for blk in plain["blocks"]:
        if blk["checkpoint"] > last_checkpoint:
            break
        planned = orch.plan_block(blk["checkpoint"], traffic.block_requests(
            orchestrator, blk["requests"]))
        for job in planned.leaf_jobs:
            w = circuits.decode_witness(
                store.get_bytes(job.input_witness_id()))
            t = w["transition"]
            out[job.hex()] = AggStateTransition(
                tuple(t["start"]), tuple(t["end"]), tuple(t["events"]))
    return out


def draw_sample(pool: list, k: int, seed: int) -> list:
    """The window's proofs to verify in full, drawn from the seed: one of
    each circuit type and of each place in a batch (``slot``) that the window
    holds, then more up to `k` in all. `pool`: (output, circuit type)."""
    order = random.Random(seed).sample(pool, len(pool))
    picked, types, slots = [], set(), set()
    for out, ct in order:
        if ct not in types or out.get("slot", 0) not in slots:
            picked.append((out, ct))
            types.add(ct)
            slots.add(out.get("slot", 0))
    chosen = {id(out) for out, _ in picked}
    rest = [x for x in order if id(x[0]) not in chosen]
    return picked + rest[:max(0, k - len(picked))]


def judge(cfg: dict, mix: dict, plain: dict, outputs: list, seed: int,
          device, cache: dict, cache_dir: Path | None = None) -> dict:
    """`outputs`: per popped job, {"job": hex, "proof": plain proof or
    None, "in_window": bool}. Returns the compared numbers, each with its
    limit, "_failed_jobs" (the hex ids of the jobs that failed) and
    "_verified" (how many proofs were verified in full)."""
    derived = family(cfg, device, cache, cache_dir)
    members = derived["members"]
    jobs = [JobID.from_bytes(bytes.fromhex(o["job"])) for o in outputs]
    want = expected_transitions(
        cfg, plain, max((j.goal_id for j in jobs), default=0))
    shape_b = cfg["family"] == "B"
    unproven, mismatched, failed = [], [], set()
    for out, job in zip(outputs, jobs):
        ct = int(job.circuit_type)
        if out["proof"] is None or ct not in members or \
                out["job"] not in want:
            unproven.append(out["job"])
            failed.add(out["job"])
            continue
        name, _ = members[ct]
        t = want[out["job"]]
        pis = list(derived["allowed"][name]) + list(t.transition_hash())
        if shape_b:
            pis += list(t.events)
        if [int(x) for x in out["proof"][0]] != [int(x) for x in pis]:
            mismatched.append(out["job"])
            failed.add(out["job"])

    k = int(mix.get("check", {}).get("verify_sample", 4))
    pool = [(o, int(j.circuit_type)) for o, j in zip(outputs, jobs)
            if o["in_window"] and o["proof"] is not None
            and int(j.circuit_type) in members]
    sample = draw_sample(pool, k, seed)
    rejected = 0
    for out, ct in sample:
        _, vd = members[ct]
        proof = convert.proof_from_plain(out["proof"])
        if not verifier.verify(proof, derived["common"], vd):
            rejected += 1
            failed.add(out["job"])
    in_window = sum(o["in_window"] for o in outputs)
    return {
        "jobs_unproven": {"value": len(unproven), "limit": 0},
        "pi_mismatches": {"value": len(mismatched), "limit": 0},
        "proofs_rejected": {"value": rejected, "limit": 0},
        # the sample must hold min(k, proofs of the window) proofs
        "proofs_unverified": {"value": max(0, min(k, in_window) -
                                           len(sample)), "limit": 0},
        "_failed_jobs": failed,
        "_verified": len(sample),
    }
