"""Service layer (L6): JSON-RPC tx ingress, read-only query API, typed
client, user signature-proving service — the reference's
city_rollup_core_node / core_api / rpc_provider / user_prover_api crates
(SURVEY.md §2.1 rows 15-19), rebuilt over the networked store/queues.

Counterpart of the reference's ``services/``: copies of ``rpc_common``,
``api_server``, ``node``, ``provider``, ``user_prover`` and
``orchestrator_service`` over the port's ``rollup/``."""
