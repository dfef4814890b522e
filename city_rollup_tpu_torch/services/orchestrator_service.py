"""Orchestrator service loop — the reference's sync_infinite_loop
(city_rollup_core_orchestrator/src/lib.rs:188-213): wait for a
produce-block command, flush the RPC ingress queues into a block, plan +
enqueue the job DAG, await the completion notification, record the block
state, repeat.

Counterpart of the reference's ``services/orchestrator_service.py``: a
copy over the port's orchestrator.
"""

from __future__ import annotations

import time

from ..rollup import orchestrator as orch_mod
from ..rollup.city_store import CityL2BlockState
from ..rollup.job_id import JobID, JobTopic
from ..rollup.queues import Q_CMD, Q_NOTIFICATIONS
from .node import PRODUCE_BLOCK_CMD, flush_rpc_requests


def wait_for_produce_block(hub, poll_s: float = 0.25,
                           timeout_s: float | None = None) -> bool:
    """Block until a produce-block command arrives (CityEventReceiver
    wait_for_produce_block twin)."""
    start = time.monotonic()
    while True:
        got = hub.receive(Q_CMD)
        if got is not None:
            mid, msg = got
            hub.ack(Q_CMD, mid)
            if msg == PRODUCE_BLOCK_CMD:
                return True
        if timeout_s is not None and time.monotonic() - start > timeout_s:
            return False
        time.sleep(poll_s)


def wait_for_block_complete(hub, planned, poll_s: float = 0.25,
                            timeout_s: float | None = None) -> bool:
    """Poll the notification queue until this block's completion
    notification arrives (wait_for_block_proving_jobs twin)."""
    start = time.monotonic()
    while True:
        got = hub.receive(Q_NOTIFICATIONS)
        if got is not None:
            mid, msg = got
            jid = JobID.from_bytes(msg)
            if jid.topic == JobTopic.NOTIFY_ORCHESTRATOR_COMPLETE and \
                    jid.goal_id == planned.checkpoint_id:
                hub.ack(Q_NOTIFICATIONS, mid)
                return True
            # another block's notification: put it back for its waiter
            # (acking + dropping would lose it permanently)
            hub.ack(Q_NOTIFICATIONS, mid)
            hub.dispatch(Q_NOTIFICATIONS, msg)
            time.sleep(poll_s)      # avoid a tight re-receive loop
        if timeout_s is not None and time.monotonic() - start > timeout_s:
            return False
        time.sleep(poll_s)


def produce_one_block(orch: orch_mod.Orchestrator, hub, checkpoint_id: int,
                      l1_context=None, extra_requests=None,
                      timeout_s: float | None = None):
    """One step_1 + step_2 cycle: flush RPC requests (merging any
    `extra_requests`), plan + enqueue, await completion, record state.
    Returns the PlannedBlock (completion awaited only when timeout given)."""
    reqs = flush_rpc_requests(hub)
    if extra_requests is not None:
        for field in ("register_users", "claim_deposits", "token_transfers",
                      "add_withdrawals", "process_withdrawals",
                      "add_deposits"):
            getattr(reqs, field).extend(getattr(extra_requests, field))
    planned = orch.plan_block(checkpoint_id, reqs, l1_context=l1_context)
    orch.enqueue(planned)
    if timeout_s is not None:
        ok = wait_for_block_complete(hub, planned, timeout_s=timeout_s)
        if not ok:
            return planned, False
        st = orch.city.get_block_state(checkpoint_id)
        orch.city.set_block_state(CityL2BlockState(
            checkpoint_id=checkpoint_id,
            next_user_id=st.next_user_id,
            next_deposit_id=st.next_deposit_id,
            next_add_withdrawal_id=st.next_add_withdrawal_id,
            next_process_withdrawal_id=st.next_process_withdrawal_id,
            end_balance=st.end_balance))
        return planned, True
    return planned, None
