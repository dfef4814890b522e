"""The rollup's host code that the check needs: job addressing, the
versioned state store, the proof store, the op / aggregation circuits of
the two shape families and the block planner (``plan_block`` without an L1
context). Copies of the port's ``rollup/`` modules of the same names."""
