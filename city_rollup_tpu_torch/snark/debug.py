"""Witness debugging: evaluate every gate constraint row-by-row on a
generated witness, without proving.

Reference role: city_common_circuit's DebugCircuitTracer (SURVEY.md §2.2
"Debug tracer" — resolves witness values to locate unsatisfied constraints).
Used heavily while developing gadgets: a full prove takes minutes, this takes
milliseconds and names the first failing (row, gate, constraint).

Counterpart of the reference's ``snark/debug.py``: the same code over the port's
``core/`` and ``snark/`` (host Python).
"""

from __future__ import annotations

import numpy as np

from ..core import gl64
from .circuit import CircuitData

P = gl64.P


def check_witness(data: CircuitData, wires, pi_hash) -> list:
    """wires: (W, n) uint64 matrix from generate_witness; pi_hash: 4 ints.
    Returns a list of violation strings (empty == all constraints hold)."""
    common = data.common
    cfg = common.config
    bad = []
    by_row = np.asarray(wires)[:cfg.num_wires].T.tolist()    # python ints
    for r, inst in enumerate(data.prover.rows):
        if inst is None:
            continue
        wrow = [(v, 0) for v in by_row[r]]
        crow = [(int(v), 0) for v in inst.constants]
        cons = inst.gate.eval_host(wrow, crow, list(pi_hash))
        for k, cv in enumerate(cons):
            if cv != (0, 0):
                bad.append(f"row {r} gate {inst.gate.key} constraint {k}: "
                           f"{cv}")
                if len(bad) > 20:
                    return bad
    # copy constraints: all wires in a class share one value. A wire that
    # was never joined to another target is a class of one and holds; the
    # others are all keys or roots of the union-find, found once each.
    builder = getattr(data, "_builder", None)
    if builder is not None:
        from .circuit import Wire

        def routed(t):
            return isinstance(t, Wire) and t.row < common.n and \
                t.col < cfg.num_routed_wires
        classes: dict = {}
        for t in list(builder.uf.parent):
            root = builder.uf.find(t)
            for w in (t, root):
                if routed(w):
                    classes.setdefault(root, set()).add(w)
        # in the order of each class's first wire, row by row
        for root, members in sorted(classes.items(),
                                    key=lambda kv: min(kv[1])):
            vals = {by_row[w.row][w.col] for w in members}
            if len(vals) > 1:
                bad.append(f"copy class {root}: values {sorted(vals)[:4]} "
                           f"across {len(members)} wires")
                if len(bad) > 20:
                    return bad
    return bad
