"""Rollup control plane: job addressing, DAG scheduling, versioned state
store, queues, worker/orchestrator actors — host-side Python mirroring the
reference's L1-L5 layers (SURVEY.md §1), driving the port's prover.

Counterpart of the reference's ``rollup/``: the in-memory block pipeline
(state store, job DAG, op / aggregation / block circuits, worker,
orchestrator, qbench), the block's L1 binding (the SHA256 accelerator,
the sighash introspection circuits, the whitelist, the sighash wrapper
and final-GL circuits, the corpus and the sighash toolbox) and the user
signatures (ZK and L1 signature circuits, wallets), the Groth16 wrap
statement (``groth16_wrap.py``), the L1 link (``link.py``) and the
networked proof store and queues (``netstore.py``) that the services
(``services/``) and the CLI's fleet subcommands run over.
"""
