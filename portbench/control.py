"""The control and the planted faults that the check must catch.

The control breaks one guarantee the configuration states: its FRI
security. The program proves with one query round fewer than the
configuration's ``num_query_rounds`` (the step a faster prover would be
tempted to take), and the reference, holding the configuration's own, has
to reject those proofs. The faults are those a leaf-proving run can have:
an answer altered where it is produced (an opening, or the statement: a
public input), a job acked with its proof never written, and half of each
batch left out.

Each entry is ``mutate(prog, work) -> undo``, planted after
set-up (``harness.run_cell(mutate=...)``).

    python -m portbench.control --workload <name> --seconds <s> \
        --seeds <n> <n> ... [--mutation fewer_queries] \
        [--sound-seeds <n> ...]

runs one process, the family built once, one run per seed (the sound
seeds first, unmutated), and prints each run's result line; it exits 0
only where every run came out as expected (sound: correct; control or
fault: not correct).
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time


def _members(work):
    fam = work.family
    return list(fam.leaves.values()) + [fam.dummy, fam.agg]


def fewer_queries(prog, work):
    """The control: every family member proves with one FRI query round
    fewer than the configuration states."""
    saved = [(m.data.common, m.data.common.config) for m in _members(work)]
    for common, cfg in saved:
        common.config = dataclasses.replace(
            cfg, fri=dataclasses.replace(
                cfg.fri, num_query_rounds=cfg.fri.num_query_rounds - 1))

    def undo():
        for common, cfg in saved:
            common.config = cfg
    return undo


def _wrap_prove_batch(prog, make):
    old = prog.prover.prove_batch
    prog.prover.prove_batch = make(old)

    def undo():
        prog.prover.prove_batch = old
    return undo


def altered_proof(prog, work):
    """Each proof's first wire opening changed after proving."""
    p = prog.prover.P

    def make(old):
        def prove_batch(data, pws, *a, **k):
            proofs = old(data, pws, *a, **k)
            for proof in proofs:
                w0, w1 = proof.openings.wires[0]
                proof.openings.wires[0] = ((int(w0) + 1) % p, w1)
            return proofs
        return prove_batch
    return _wrap_prove_batch(prog, make)


def altered_statement(prog, work):
    """Each proof claims another state transition: a public input of the
    transition's hash changed after proving."""
    p = prog.prover.P

    def make(old):
        def prove_batch(data, pws, *a, **k):
            proofs = old(data, pws, *a, **k)
            for proof in proofs:
                proof.public_inputs[4] = (int(proof.public_inputs[4]) + 1) % p
            return proofs
        return prove_batch
    return _wrap_prove_batch(prog, make)


def half_batch(prog, work):
    """prove_batch proves the first half of its batch only (none of a
    batch of one); the worker acks the jobs it got proofs for."""
    def make(old):
        def prove_batch(data, pws, *a, **k):
            return old(data, pws[:len(pws) // 2], *a, **k) \
                if len(pws) > 1 else []
        return prove_batch
    return _wrap_prove_batch(prog, make)


def unwritten_proof(prog, work):
    """The worker acks each job with its proof never written."""
    store = work.store
    old = store.set_bytes

    def set_bytes(jid, data):
        if jid == jid.output_proof_id():
            return None
        return old(jid, data)
    store.set_bytes = set_bytes

    def undo():
        store.set_bytes = old
    return undo


MUTATIONS = {"fewer_queries": fewer_queries, "altered_proof": altered_proof,
             "altered_statement": altered_statement,
             "half_batch": half_batch, "unwritten_proof": unwritten_proof}


def main(argv=None) -> int:
    import argparse

    from . import harness, manifest
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--mutation", choices=sorted(MUTATIONS))
    ap.add_argument("--sound-seeds", type=int, nargs="*", default=[],
                    help="seeds run first without a mutation, in the same "
                         "process")
    args = ap.parse_args(argv)
    runs = [(s, None) for s in args.sound_seeds] + \
        [(s, args.mutation) for s in args.seeds]
    cache = {"keep": True}
    ok = True
    for seed, mutation in runs:
        t = time.perf_counter()
        res = harness.run_cell(
            args.workload, seed, args.seconds, False, t,
            manifest.HERE.parent, cache=cache,
            mutate=MUTATIONS[mutation] if mutation else None)
        res["seed"] = seed
        res["mutation"] = mutation
        res["run_s"] = time.perf_counter() - t
        print(json.dumps(res), flush=True)
        ok &= res["correct"] == (mutation is None)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
