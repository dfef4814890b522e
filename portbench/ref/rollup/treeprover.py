"""Treeprover data model: state-transition aggregation over binary trees.

Reference role: city_crypto/src/hash/merkle/treeprover/mod.rs (SURVEY.md
§2.6) — `AggStateTransition{,WithEvents}` condense pairs of child transitions
(left.start -> right.end; events combine via Poseidon two-to-one), and
`generate_tree_inputs_with_position` fills a BinaryTreePlanner tree with
aggregation inputs, odd nodes carried up as pass-throughs.

Counterpart of the reference's ``rollup/treeprover.py``: a copy.
"""

from __future__ import annotations

import dataclasses

from ..core import poseidon_host
from .tree_planner import plan_binary_tree

Digest = tuple[int, int, int, int]
ZERO: Digest = (0, 0, 0, 0)


def combine_events(left: Digest, right: Digest) -> Digest:
    return tuple(poseidon_host.two_to_one(list(left), list(right)))


@dataclasses.dataclass(frozen=True)
class AggStateTransition:
    """A proven claim: state root moved start -> end (optionally emitting an
    event accumulator hash)."""
    start: Digest
    end: Digest
    events: Digest = ZERO

    def transition_hash(self) -> Digest:
        return tuple(poseidon_host.two_to_one(list(self.start),
                                              list(self.end)))


@dataclasses.dataclass(frozen=True)
class AggStateTransitionInput:
    """Witness for one aggregation node: two child transitions (either may be
    a carried-up single child when the level was odd)."""
    left: AggStateTransition
    right: AggStateTransition | None
    level: int
    index: int

    def condense(self) -> AggStateTransition:
        if self.right is None:
            return self.left
        assert self.left.end == self.right.start, \
            "child transitions do not chain"
        return AggStateTransition(
            start=self.left.start, end=self.right.end,
            events=combine_events(self.left.events, self.right.events))


def generate_tree_inputs(leaves: list[AggStateTransition]
                         ) -> list[list[AggStateTransitionInput]]:
    """Fill a binary aggregation tree: per level, the pairing jobs over the
    previous level's condensed transitions (treeprover/mod.rs:385 twin)."""
    if not leaves:
        return []
    levels_plan = plan_binary_tree(len(leaves))
    out: list[list[AggStateTransitionInput]] = []
    cur = list(leaves)
    for jobs in levels_plan:
        inputs = []
        nxt = []
        for j in jobs:
            left = cur[j.left]
            right = cur[j.right] if j.right is not None else None
            inp = AggStateTransitionInput(left=left, right=right,
                                          level=j.level, index=j.index)
            inputs.append(inp)
            nxt.append(inp.condense())
        out.append(inputs)
        cur = nxt
    return out


def tree_root_transition(leaves: list[AggStateTransition]
                         ) -> AggStateTransition:
    """The condensed root claim of the whole tree (identity for 1 leaf)."""
    assert leaves
    cur = list(leaves)
    for level in generate_tree_inputs(leaves):
        cur = [inp.condense() for inp in level]
    return cur[0] if cur else leaves[0]
