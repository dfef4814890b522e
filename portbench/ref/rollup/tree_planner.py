"""Binary aggregation-tree planner.

Levels of (position, left, right) jobs over n leaves; an odd node at the end
of a level is carried up unpaired to the next level. Reference role:
city_common/src/tree_planner.rs:60-85 (SURVEY.md §2.13), used both for job-ID
trees and witness trees.

Counterpart of the reference's ``rollup/tree_planner.py``: a copy.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BinaryTreeJob:
    level: int
    index: int           # position within its level
    left: int            # index into previous level (or leaves for level 1)
    right: int | None    # None = odd carry-up (copy left)


def plan_binary_tree(num_leaves: int) -> list[list[BinaryTreeJob]]:
    """Levels of pairing jobs (level 1 pairs leaves) until one node remains.
    Returns [] for num_leaves <= 1."""
    if num_leaves <= 1:
        return []
    levels: list[list[BinaryTreeJob]] = []
    width = num_leaves
    level = 1
    while width > 1:
        jobs = []
        out = 0
        i = 0
        while i < width:
            if i + 1 < width:
                jobs.append(BinaryTreeJob(level, out, i, i + 1))
            else:
                jobs.append(BinaryTreeJob(level, out, i, None))
            out += 1
            i += 2
        levels.append(jobs)
        width = out
        level += 1
    return levels


def tree_height(num_leaves: int) -> int:
    return len(plan_binary_tree(num_leaves))
