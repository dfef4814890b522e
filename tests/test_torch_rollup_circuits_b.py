"""The port's shape family B (process_withdrawal, add_deposit, its dummy
and its self-recursive aggregator, with the events public inputs) against
the reference's, at test_torch_rollup_circuits.py's small_params, and the
witnesses of a block that deposits and then processes a withdrawal."""

import numpy as np
import pytest
import torch

from city_rollup_tpu.rollup import circuits as jcircuits
from city_rollup_tpu.snark import circuit as jcircuit
from city_rollup_tpu_torch.core import fri
from city_rollup_tpu_torch.rollup import circuits, op_circuits as oc
from city_rollup_tpu_torch.rollup import orchestrator as om
from city_rollup_tpu_torch.rollup.city_store import CityStore
from city_rollup_tpu_torch.rollup.proof_store import MemoryProofStore
from city_rollup_tpu_torch.rollup.queues import QueueHub
from city_rollup_tpu_torch.snark import CircuitConfig, circuit
from test_torch_rollup_circuits import (ALLOWED_ROOT, FAMILY_LOG_N,
                                        TEST_HEIGHT, assert_members_equal,
                                        families, small_params)


@pytest.fixture(scope="module")
def family_b():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield families("B")
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", ["process_withdrawal", "add_deposit",
                                  "dummy", "agg"])
def test_family_b_member_equals_the_reference(family_b, name):
    port, ref = family_b
    assert port.common.log_n == FAMILY_LOG_N
    assert port.common.num_public_inputs == 12
    assert_members_equal(port, ref, name)


def _deposit_block():
    """A block with one deposit added and one withdrawal processed (the
    withdrawal added the block before), planned by the port."""
    pp = small_params(oc, CircuitConfig, fri.FriConfig)
    city = CityStore(user_tree_height=TEST_HEIGHT,
                     deposit_tree_height=TEST_HEIGHT,
                     withdrawal_tree_height=TEST_HEIGHT)
    city.register_user(0, 0, (1, 1, 1, 1))
    city.increment_user_balance(0, 0, 10_000 + pp.withdrawal_fee)
    city.add_withdrawal(0, 0, (5, 6, 7), 100)
    store = MemoryProofStore()
    planned = om.Orchestrator(city, store, QueueHub(), params=pp).plan_block(
        1, om.BlockRequests(
            process_withdrawals=[om.ProcessWithdrawal(0)],
            add_deposits=[om.AddDeposit(0, (1, 2, 3, 4),
                                        tuple(range(1, 10)), 5000)]))
    return planned, store


@pytest.mark.parametrize("name", ["process_withdrawal", "add_deposit"])
def test_family_b_op_witness_equals_the_reference(family_b, name):
    port, ref = family_b
    planned, store = _deposit_block()
    job = next(j for j in planned.leaf_jobs
               if circuits.OP_NAME_BY_TYPE.get(j.circuit_type) == name)
    raw = store.get_bytes(job.input_witness_id())
    wires = []
    for fam, dec, gen in (
            (port, circuits.decode_witness, circuit.generate_witness),
            (ref, jcircuits.decode_witness, jcircuit.generate_witness)):
        built = fam.leaves[name]
        pw = built.data._builder.partial_witness()
        built.setter(pw, dict(dec(raw), allowed_root=ALLOWED_ROOT))
        wires.append(np.asarray(gen(built.data, pw), dtype=np.uint64))
    assert np.array_equal(wires[0], wires[1])
    # the event public inputs: the withdrawal leaf / the deposit leaf
    data = port.leaves[name].data
    pw = data._builder.partial_witness()
    port.leaves[name].setter(pw, dict(circuits.decode_witness(raw),
                                      allowed_root=ALLOWED_ROOT))
    circuit.generate_witness(data, pw)
    events = [pw.get(t) for t in data.prover.pi_targets[8:12]]
    want = planned.withdrawal_events[0] if name == "process_withdrawal" \
        else planned.deposit_events[0]
    assert tuple(events) == tuple(want)
