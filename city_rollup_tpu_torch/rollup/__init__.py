"""Rollup control plane: job addressing, DAG scheduling, versioned state
store, queues, worker/orchestrator actors — host-side Python mirroring the
reference's L1-L5 layers (SURVEY.md §1), driving the port's prover.

Counterpart of the reference's ``rollup/``: the in-memory block pipeline
(state store, job DAG, op / aggregation / block circuits, worker,
orchestrator, qbench). The signature, sighash, Groth16 and network modules
come with later slices.
"""
