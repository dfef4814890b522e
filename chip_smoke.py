#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (city_rollup_tpu_torch) on one GPU.

    python3 chip_smoke.py

In order, it:
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the CUDA kernels from city_rollup_tpu_torch/csrc/ (nvcc, one
     process per source, all started together) and prints each kernel's
     registers and spills (-Xptxas -v) as one JSON line;
  3. holds each kernel bit for bit against its plain PyTorch version on the
     card, at the shapes the commit, FRI and prove paths give it and at
     edge values: K1 and K2 at log_m 14, 23 (batch 1, and the one-shot
     commit's 64) and 25 (one streamed slab of 8) as coset LDEs, 8 (batch
     1 and 8) and 5 (inverse, with the output scaling), and the prover's
     intt of (B x 144, 2^12), coset LDE 2^12 -> 2^15 and quotient
     coset_intt of (B x 2, 2^15) (B = PROVE_BATCH); the tail kernel, off
     those paths,
     directly and through a transform with MAX_KERNEL_LOG lowered; K4 at
     the prover's leaf widths (a partial last sponge chunk) and its
     Merkle-level entry (reduce_level_t);
  4. holds the 2^10 x 16 seed-7 cap against GOLDEN_CAP, the reference
     package's output for the same input (pinned by
     tests/test_torch_pipeline.py), and the small seed-7 FRI proof against
     GOLDEN_FRI (pinned by tests/test_torch_fri.py);
  5. drives the commit path once with every launch count set to 0:
     lde_commit at 2^18 x 64 and lde_commit_streamed at 2^22 x 64
     (rate_bits 3, cap_height 4), then holds streamed == one-shot at
     2^18 x 64;
  6. drives the FRI path once with every launch count set to 0, under
     FriConfig() defaults: fri_prove of a degree < 2^18 ext codeword
     (log_m 21) and fri_prove_batch of 8 codewords at log_m 20; then holds
     batch proof 0 == fri_prove of codeword 0 alone, and has the host
     fri_verify accept the full-width and one batch proof and reject the
     full-width proof with one final-poly coefficient changed;
  7. proves, with the snark prover: the tests' tiny circuit against
     GOLDEN_PROOF (the reference's proof, pinned by
     tests/test_torch_snark.py), then the prove path once with every launch
     count set to 0, at the full prover width (CircuitConfig.
     poseidon_config(), FriConfig() defaults): FULL_PATHS Merkle-path
     membership checks of height 32 filling 2^12 rows, preprocessed, then
     prove (B = 1) cold and warm and prove_batch of PROVE_BATCH witnesses,
     with each
     run's wall time, peak device memory and step times; then has the host
     verifier accept every proof and reject a tampered one, and holds batch
     proof 0 == prove of its witness alone;
  8. recursion: the tests' tiny chain (an inner proof wrapped by a 2^10
     circuit that verifies it in-circuit) against GOLDEN_WRAP_PROOF (the
     reference's proof, pinned by tests/test_torch_recursion.py); then, at
     full width (poseidon_config(), FriConfig() at both levels), builds the
     wrapper of the prove path's leaf proof (minifier.ProofMinifier: the
     leaf's verifier data as constants, its 384 public inputs exposed
     again; 2^15 rows) and the aggregation step's circuit, and holds K1/K2
     and K4 at the shapes of both proves (every committed matrix's intt
     and coset LDE, the quotient's coset_intt, the leaf widths), then
     drives the recursion path once with every launch count set to 0: the
     wrapper's preprocessing, its prove, and an
     aggregation-style step (aggregation_circuit: the wrapper's proof
     verified against verifier data given as witness, its fingerprint the
     public input); then has the host verifier accept both proofs, checks
     their public inputs, has check_witness accept the wrapper's witness,
     and has a leaf proof with one wire opening changed fail: no wrapper
     witness completes, and check_witness names the gates a forged one
     breaks;
  9. the rollup's block pipeline at DEFAULT_PARAMS (rollup_phase): the
     CircuitToolbox's circuits (shape families A and B, block parts 1 and
     2, the block transition) built and held against GOLDEN_ROLLUP_SHAPES
     (the reference's host build), K1/K2, K3 and K4 held at its shapes
     (2^16 and 2^17 rows, 2^19 and 2^20 LDE points), then, with every
     launch count set to 0 before the circuits' preprocessing and before
     each block: the CLI's demo block (cli.demo_genesis, demo_requests)
     planned, drained by Worker.process_next_job and finalized, then
     block2_requests on top of it drained by process_ready_batch(8) (one
     prove_batch of B = 2 for each pair of same-circuit leaves) and
     finalized; each block's city roots against GOLDEN_BLOCK_ROOTS (the
     reference's plan), the transition proofs' public inputs against
     them, every job's proof through the host verifier (in worker
     processes), and a transfer aggregation over a child proof with one
     wire opening changed: no witness completes, and check_witness names
     the gates a forged one breaks. Block 2 carries its L1 transaction,
     which spends the dev covenant (btc.dev_spend_cfg()): the sighash
     toolbox of its one shape (the SHA256 accelerator, the shape circuit,
     the minified shape, the whitelist wrapper, the final GL over the
     block transition) and the signature circuits (the ZK wrapper, a
     transfer op that verifies it) are built after the rollup's, held
     against GOLDEN_SIGHASH_SHAPES (the reference's host build) and in the
     kernel checks; the worker proves the chain (introspection, wrapper,
     final GL) before the block's completion notification, the final GL's
     public inputs are checked against the host's felt248 of the old root
     and felt252 of the sighash, every proof of the chain host-verified,
     and a final GL with a wrong spend index refused; then a wallet signs
     a transfer and a withdrawal, the signed transfer op proves one
     signature and verifies, and gives no witness when the sender's leaf
     holds another key. The sighash path's launches (its circuits'
     preprocessing, its proves, the signatures) are counted apart from
     the rollup path's. Block 2 goes through the fleet's services: the
     port's store-server and rpc-server as subprocesses of its CLI, the
     query API over this process's CityStore, the requests sent to the
     node with CityRpcProvider (a signed transfer refused: the fleet runs
     without signature verification), the orchestrator service (a
     thread: wait_for_produce_block, produce_one_block with the L1
     context and its Groth16 wrap) and the worker over NetProofStore /
     NetQueueHub; the completion notification comes after the wrap, whose
     public inputs are checked against the host's pack_state and
     binding_digest of the final GL's, groth16.verify accepts it and
     rejects each public input changed, assemble_l1_transaction refuses
     without a dev-mode flag and with one returns the block transaction
     (the wrap's pushes, the covenant script) broadcast on a
     MemoryBTCLink; the node, forwarding to the api server, answers block
     2's city root and the wrap's stored bytes; and a signature is proved
     through the user-prover service and verified. Every service is
     stopped at the end, on failure too;
 10. the parallel path (city_rollup_tpu_torch.parallel, parallel_phase)
     at world size 1 over NCCL, last, since nothing may fork or start a
     process while its process group is live: K1/K2 and K4 held and timed
     at its shapes, then, with every launch count set to 0, dist_lde_commit
     of a degree-2^20 polynomial to 2^23 points (leaves of 8, cap 2^4),
     dist_batched_coset_lde then dist_merkle_cap at 2^20 x 64, dist_ntt at
     2^23 and prove_batch(mesh=) of the prove path's circuit at B =
     PROVE_BATCH; each held bit for bit against the single-device result
     (coset_lde + MerkleTree, coset_lde and lde_commit, ntt), the proofs
     field for field against the prove path's batch, with the group's
     set-up time, each call's time beside the single-device call's, the
     mesh prove's steps and the proofs' gather, and the peak device memory;
 11. times each kernel, its plain version and its bound, and the whole
     coset LDE of one streamed slab and of the one-shot input against its
     byte bound, and K4, K1 and K2 at the prove and recursion paths'
     shapes (K1 + K2 against the transform's bound: its input read once,
     its output written once; beside it the four-step figure, which adds
     the intermediate's write and read), and at the rollup path's;
and prints one JSON line of the prove path, one of the recursion path, one
of the rollup path (per job: circuit, rows, log_n, wall time, witness
share, peak device memory; the builds, blocks and verifies; the sighash
circuits and jobs; the signatures; the Groth16 wrap; the services), one
of the parallel path, one of the
LDE, prove-path, recursion-path and rollup-path kernel times, one of
kernels,
then as its last line
{"ok": true, "device": {...}}. Any failure raises, and the exit code is then
non-zero. Without CUDA, or without the port's package beside it, it fails
before printing any result.
"""

from __future__ import annotations

import contextlib
import copy
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

# lde_commit(seed-7 (16, 2^10) coefficients, rate_bits=3, cap_height=4) of the
# reference package: rng = np.random.default_rng(7);
# rng.integers(0, p, size=(16, 1 << 10), dtype=np.uint64).
GOLDEN_CAP = [
    [11124996842486871537, 10833226710434570248, 334947422782506836,
     7324785774463782700],
    [12116386283352661960, 14572115498849026540, 3137748986343091037,
     1304443284651871459],
    [1285419751905360104, 8515709841998993865, 5232441924630985373,
     10731464001642126370],
    [921681907808615568, 13614237725161628466, 7556640878426855404,
     15667972229409145603],
    [18110795192343001320, 16876325810625285586, 6389919662479316352,
     14365175204868636465],
    [6587463079462474938, 18229493583769498929, 8029539611463489431,
     6244683394304848565],
    [5881539990576622936, 16623942268915977758, 8208850414919324351,
     3139811855568406526],
    [2847808961485792819, 13099154217433896463, 10607595661719848756,
     4188086017798558097],
    [12832247690296705220, 15847351210345129980, 14499718918289721065,
     1069968029294636718],
    [17315346944395933855, 626757209227384649, 6221817845828124801,
     15781429029086660173],
    [2731397667907347310, 7503946682576353579, 12014580744366564829,
     1477600393405705802],
    [16284171226313858328, 628795544168661531, 12059498054992212474,
     6214877434631526776],
    [15833012049825875419, 17614137492766471773, 3712483260403742995,
     12403048936786055368],
    [5102577065230592266, 5110988086667735555, 16055412538870542304,
     4028766581770013121],
    [2223793420804954971, 652752460381871701, 8744696652168684216,
     12487654981067301618],
    [4779777903681048061, 5962994489761700447, 1364215374758113891,
     8413657776722638697],
]

RATE_BITS, CAP_HEIGHT = 3, 4
P = 0xFFFF_FFFF_0000_0001

# fri_prove of the reference package under tests/test_fri.py's configuration
# (GOLDEN_FRI_CONFIG), on the ext codeword (coset_lde(c0), coset_lde(c1))
# at log_n 5, rate_bits 3 (so log_m 8), shift 7, with (c0, c1) =
# golden_fri_coeffs(). The query rounds are pinned by their digest
# (fri_rounds_digest).
GOLDEN_FRI_CONFIG = dict(rate_bits=3, cap_height=2, proof_of_work_bits=8,
                         num_query_rounds=8, final_poly_bits=2)
GOLDEN_FRI = {
    "commit_caps": [
        [[13449938158765108056, 8881390454570414133, 13398381813488741411,
          4869752172477585490],
         [15710094558302479922, 6629462921364777469, 16117752112057565543,
          8988166806681319727],
         [3982692405914353061, 6185059800053397535, 12010183869404489043,
          14909577760504420280],
         [10875173173593366071, 856675227107874614, 2518123291468308538,
          246160804427729804]],
        [[6689756446247076064, 10409171409550181669, 7046739843533935038,
          13777913260887888723],
         [2758204981224789468, 17421031213549773259, 8026653170983447463,
          3804662607837861862],
         [3825613688703128471, 9176524537224326706, 7488640656908480545,
          17560997262294401070],
         [17688969927530906696, 13040619944251770913, 11604620800676870705,
          494541790547035470]],
        [[862146937927186500, 6820359941652963344, 2571669238078150462,
          4978490874666883096],
         [2496915278938699500, 16084206256467119204, 11138216908952256442,
          16568484609338253236],
         [10241546610905315096, 4639689868781107267, 8482719434226280969,
          3748798217260830913],
         [9464659021140777186, 14529965438656412578, 992997647130692368,
          15957078606786010461]]],
    "final_poly": [[9443423741523691392, 10650559413001562589],
                   [10856518252411826914, 9087883669729363072],
                   [6385707355905939514, 18111612534455992059],
                   [16386313636446941205, 12500323945010713965]],
    "pow_witness": 210,
    "query_indices": [230, 139, 59, 194, 164, 134, 33, 2],
    "query_rounds_digest": [727104419784742847, 7111512577969498849,
                            16781506841225234962, 11268056122848166510],
}

# proof_digest(convert.proof_to_plain(proof)) of the reference package's
# snark prove of tiny_circuit (x = 3) under fast_config (zk off), built with
# build() (pinned by tests/test_torch_snark.py).
GOLDEN_PROOF = [16907637346382866868, 7186342146289174102,
                1575200190949228284, 10531905707465559276]

# proof_digest of the reference package's proof of the tiny recursion chain:
# ProofMinifier.build(inner, wrap).prove(inner proof), where inner is
# recursion_inner_circuit at RECURSION_INNER_XY and (inner, wrap) =
# recursion_configs(...), zk off (pinned by tests/test_torch_recursion.py).
GOLDEN_WRAP_PROOF = [3679485471568767130, 946507281515921971,
                     3451506921347395455, 1019042481076856273]

# The snark prover's circuits, one builder function each, run against either
# package's CircuitBuilder. FAST_FRI is tests/test_device_passes.py's small
# configuration (num_challenges 1); the full width is
# CircuitConfig.poseidon_config() (144 wires) with FriConfig() defaults.
FAST_FRI = dict(rate_bits=3, cap_height=1, proof_of_work_bits=4,
                num_query_rounds=4, final_poly_bits=3)
# Merkle paths of the state trees' height, and as many of them as fill
# build(min_log_n=12) (tests/test_torch_snark_circuit.py checks that one
# more does not fit).
MERKLE_HEIGHT = 32
FULL_LOG_N = 12
FULL_PATHS = 48


def fast_config(config_cls, fri_config_cls, zk: bool = False):
    return config_cls.poseidon_config(num_challenges=1, zk=zk,
                                      fri=fri_config_cls(**FAST_FRI))


def tiny_circuit(b):
    """y = x * x with y public; returns x."""
    x = b.add_virtual_target()
    b.register_public_input(b.mul(x, x))
    return x


def merkle_paths_circuit(b, num_paths: int, height: int = MERKLE_HEIGHT):
    """num_paths Merkle-path membership checks: per level one conditional
    swap (4 arithmetic ops a felt pair, the bit constrained to 0/1) and
    one hash_two_to_one (a Poseidon row). Each path's leaf and computed
    root are public inputs. Returns per path (leaf, bits, siblings)."""
    p = P
    paths = []
    for _ in range(num_paths):
        leaf = b.add_virtual_hash()
        bits = b.add_virtual_targets(height)
        sibs = [b.add_virtual_hash() for _ in range(height)]
        cur = leaf
        for bit, sib in zip(bits, sibs):
            b.assert_zero(b.arithmetic(1, p - 1, bit, bit, bit))
            left, right = [], []
            for c, s in zip(cur, sib):
                d = b.sub(s, c)
                left.append(b.mul_add(bit, d, c))         # c + bit (s - c)
                right.append(b.arithmetic(p - 1, 1, bit, d, s))   # s - bit d
            cur = b.hash_two_to_one(left, right)
        b.register_public_inputs(leaf)
        b.register_public_inputs(cur)
        paths.append((leaf, bits, sibs))
    return paths


def merkle_paths_witness(b, paths, seed: int):
    """A partial witness of random leaves, index bits and siblings."""
    rng = np.random.default_rng(seed)
    pw = b.partial_witness()
    for leaf, bits, sibs in paths:
        for t in leaf + [t for s in sibs for t in s]:
            pw.set(t, int(rng.integers(0, P, dtype=np.uint64)))
        for t in bits:
            pw.set(t, int(rng.integers(0, 2)))
    return pw


# The recursion path. The tiny chain is tests/test_recursion.py's: an
# inner circuit under a small FRI, wrapped by a 144-wire circuit whose FRI
# differs only in its cap height. At full width both levels are
# CircuitConfig.poseidon_config() with FriConfig() defaults, and the leaf is
# merkle_paths_circuit's.
RECURSION_FRI = dict(rate_bits=3, cap_height=1, proof_of_work_bits=4,
                     num_query_rounds=4, final_poly_bits=2)
RECURSION_INNER_XY = (3, 5)


def recursion_configs(config_cls, fri_config_cls):
    """(inner, wrapper) configurations of the tiny recursion chain."""
    inner = config_cls(num_routed_wires=32, num_wires=32, num_challenges=2,
                       fri=fri_config_cls(**RECURSION_FRI))
    wrap = config_cls(num_routed_wires=32, num_wires=144, num_challenges=2,
                      fri=fri_config_cls(**dict(RECURSION_FRI,
                                                cap_height=2)))
    return inner, wrap


def recursion_inner_circuit(b):
    """out = x * y + x + 7 with out public; returns (x, y)."""
    x = b.add_virtual_target()
    y = b.add_virtual_target()
    b.register_public_input(b.add_const(b.add(b.mul(x, y), x), 7))
    return x, y


def aggregation_circuit(b, recursion, child_common):
    """Verify one proof of shape child_common against verifier data given
    as witness, the way an aggregation node admits a child (without the
    fingerprint enum): the fingerprint of that verifier data is the
    circuit's public input. Returns (proof targets, verifier-data
    targets)."""
    pt = recursion.add_virtual_proof(b, child_common)
    vdt = recursion.add_virtual_verifier_data(b, child_common)
    recursion.verify_proof_gadget(b, pt, child_common, vdt)
    b.register_public_inputs(recursion.fingerprint_gadget(b, vdt))
    return pt, vdt


def with_target_value(data, wires, target, value: int):
    """A copy of the (W, n) witness matrix of a circuit built by the port,
    with every routed wire of target's copy class set to value: a witness
    that agrees with itself on the copy constraints, for check_witness to
    find the gate constraints that value breaks."""
    wire_class, roots = data.prover.wire_classes
    k = roots.index(data._builder.uf.find(target))
    out = wires.copy()
    routed = out[:wire_class.shape[0]]
    routed[wire_class == k] = value
    return out


def gate_row_counts(data) -> dict:
    """Rows of each gate kind in a built circuit."""
    rows = {}
    for r in data.prover.rows:
        if r is not None:
            rows[r.gate.key] = rows.get(r.gate.key, 0) + 1
    return rows


def full_width_circuit(builder_cls, config_cls):
    """(builder, paths, data) of the prove path's full-width circuit:
    FULL_PATHS Merkle paths in 2^FULL_LOG_N rows, poseidon_config()."""
    b = builder_cls(config_cls.poseidon_config())
    paths = merkle_paths_circuit(b, FULL_PATHS)
    return b, paths, b.build(min_log_n=FULL_LOG_N)


def wrapper_of(data, minifier, recursion):
    """The wrapper of the circuit `data` (ProofMinifier.build: verifier
    data as circuit constants, the public inputs exposed again) and a
    function that makes its partial witness over one proof of `data`,
    filled after build as the minifier's own prove does."""
    wrap = minifier.ProofMinifier.build(data)

    def witness(proof):
        pw = wrap.data._builder.partial_witness()
        recursion.set_proof_witness(pw, wrap.proof_targets, proof)
        return pw
    return wrap, witness


# Bounds (H100 SXM datasheet peaks at 700 W): 3.35 TB/s of device
# memory, and 67e12 operations/s outside the tensor cores (the float32 rate,
# a multiply-add counted as 2). There is no faster rate for 32-bit integer
# work on the CUDA cores, so the integer bound below is a lower bound.
MEM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
# Operations counted: a Goldilocks multiply is four 32x32 -> 64 products of
# two multiply-adds each (16 operations); an MDS entry times a u64 is two
# multiply-adds (4 operations; the core does them as two FP64 DFMAs). Adds,
# compares and reductions are not counted, so the count is a lower bound.
OPS_MULMOD = 16
OPS_MDS_ENTRY = 4
OPS_PERMUTATION = (8 * 12 * 4 + 22 * 4) * OPS_MULMOD + 30 * 144 * OPS_MDS_ENTRY



def ntt_pair_bounds_ms(rows: int, n_in: int, n_out: int) -> tuple:
    """(bound, four-step) byte times of one K1 + K2 transform of `rows`
    rows, n_in values each in and n_out out. The bound is the function's:
    the input read once, the output written once. The four-step figure
    adds K1's write and K2's read of the intermediate (n_out values a
    row), which the two-kernel design must move."""
    bound = 8 * rows * (n_in + n_out) / MEM_BYTES_PER_S * 1e3
    return bound, bound + 16 * rows * n_out / MEM_BYTES_PER_S * 1e3


def ntt_products(log_m: int, n_values: int) -> int:
    """Full 64x64 products that ntt_block_kernel's passes do over n_values
    values in transforms of 2^log_m: the twiddles between passes (all but
    k = 0 of each radix-2^r group), and the radix twiddles 2^e that are
    not a shift (e mod 96 >= 64; w_16 = 2^156). Shifts, adds and the
    reductions are not counted."""
    passes = max(1, -(-log_m // 4))
    total = 0
    for p in range(passes):
        rl = log_m // passes + (p < log_m % passes)
        r = 1 << rl
        radix = sum(1 for s in range(rl) for i in range(r // 2)
                    if (156 * (i & ((1 << s) - 1)) * (8 >> s)) % 96 >= 64)
        total += n_values // r * radix
        if p + 1 < passes:
            total += n_values // r * (r - 1)
    return total


# The kernels each path must launch (by their LAUNCHES names). The FRI path
# hashes every layer's tree levels (K4), grinds (K3) and interpolates the
# final polynomial (K1, K2: log_m 8, so no tail stage).
# The tail kernel runs only past K2's 2^13-value segments, which no commit
# reaches; it is driven directly in the kernel checks.
COMMIT_KERNELS = ("ntt_fourstep_tw", "ntt_block", "poseidon_sponge",
                  "poseidon_absorb")
FRI_KERNELS = ("ntt_fourstep_tw", "ntt_block", "poseidon_permute",
               "poseidon_sponge")
# The prove path interpolates and extends every committed matrix (K1, K2),
# hashes its leaves and tree levels (K4) and runs FRI, which grinds (K3).
PROVE_KERNELS = ("ntt_fourstep_tw", "ntt_block", "poseidon_permute",
                 "poseidon_sponge")
# The prove path's batch and the leaf widths its trees hash: wires (144, zk
# 148), Z and partial products (10, zk 14), quotient chunks (16, zk 20);
# the constants/sigmas width S is the circuit's. The batch was 8 until the
# script had to fit block 2's fleet and Groth16 wrap into the call's time:
# 2 is a leaf level's pairs, the B the rollup's blocks prove.
PROVE_BATCH = 2
# The one-shot commit (was 2^20 x 64, BASELINE's config 2) and FRI's
# single codeword (was log_m 23), cut for the same reason.
ONE_SHOT_LOG_N = 18
FRI_LOG_N = 18
PROVE_LEAF_WIDTHS = (10, 14, 16, 20, 144, 148)


class StepTimer:
    """prove_batch's on_step: the wall time of each step, the device
    synchronised at both of its ends."""

    def __init__(self):
        self.steps = {}
        self.last = None

    def start(self):
        torch.cuda.synchronize()
        self.last = time.perf_counter()

    def __call__(self, name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        self.steps[name] = self.steps.get(name, 0.0) + now - self.last
        self.last = now


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, after one warm-up."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest |got - want| over the u64 values; 0 when bit for bit equal."""
    if torch.equal(got, want):
        return 0
    bad = got != want
    g = got[bad].cpu().numpy().view(np.uint64).astype(object)
    w = want[bad].cpu().numpy().view(np.uint64).astype(object)
    return max(abs(int(a) - int(b)) for a, b in zip(g, w))


def require_equal(got, want, what: str) -> None:
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"{what}: kernel disagrees with its plain "
                             f"version (max abs err {err})")
    log(f"check {what}: bit for bit")


def card_felts(gen: torch.Generator, shape) -> torch.Tensor:
    """Canonical random felts made on gen's device (hi < 2^32 - 1)."""
    lo = torch.randint(0, 1 << 32, shape, generator=gen, device=gen.device)
    hi = torch.randint(0, (1 << 32) - 1, shape, generator=gen,
                       device=gen.device)
    return (hi << 32) | lo


def require_launched(launches: dict, names, path: str) -> None:
    zero = [k for k in names if launches[k] == 0]
    if zero:
        raise AssertionError(f"kernels never launched on the {path} path: "
                             f"{zero}")


def golden_fri_coeffs() -> tuple[np.ndarray, np.ndarray]:
    """The coefficient pair of GOLDEN_FRI's codeword (degree < 2^5)."""
    rng = np.random.default_rng(7)
    c0 = rng.integers(0, P, size=1 << 5, dtype=np.uint64)
    c1 = rng.integers(0, P, size=1 << 5, dtype=np.uint64)
    return c0, c1


def fri_rounds_digest(proof) -> list[int]:
    """poseidon_host.hash_no_pad of a FriProof's query rounds, flattened:
    round by round, layer by layer, the coset's four felts, then the Merkle
    path's digests."""
    from city_rollup_tpu_torch.core import poseidon_host
    felts = []
    for rnd in proof.query_rounds:
        for layer in rnd:
            for v in layer.coset:
                felts.extend(int(x) for x in v)
            for d in layer.merkle_path:
                felts.extend(int(x) for x in d)
    return poseidon_host.hash_no_pad(felts)


def golden_fri_differences(proof) -> list[str]:
    """The fields of GOLDEN_FRI that a FriProof (of either package) does
    not reproduce."""
    got = {
        "commit_caps": [np.asarray(c, dtype=np.uint64).tolist()
                        for c in proof.commit_caps],
        "final_poly": [[int(a), int(b)] for a, b in proof.final_poly],
        "pow_witness": int(proof.pow_witness),
        "query_indices": [int(i) for i in proof.query_indices],
        "query_rounds_digest": fri_rounds_digest(proof),
    }
    return [k for k, want in GOLDEN_FRI.items() if got[k] != want]


def proof_digest(plain) -> list[int]:
    """poseidon_host.hash_no_pad of a proof's plain form
    (convert.proof_to_plain), flattened depth first."""
    from city_rollup_tpu_torch.core import poseidon_host

    def flat(x):
        if isinstance(x, list):
            for v in x:
                yield from flat(v)
        else:
            yield x
    return poseidon_host.hash_no_pad(list(flat(plain)))



# --- the rollup's block pipeline (rollup/, cli.py) ------------------------
# The start and end city roots of the CLI's demo block (checkpoint 1, after
# cli.demo_genesis) and of BLOCK2 on top of it (checkpoint 2): the
# reference package's Orchestrator.plan_block on the same requests at
# DEFAULT_PARAMS' tree heights (pinned by tests/test_torch_rollup_plan.py).
GOLDEN_BLOCK_ROOTS = [
    [[13272895875839011391, 15398019101049385666, 67975128415407651,
      16707484779058638326],
     [13520145760351561049, 14628790721292608042, 9280862984646714284,
      16724360801538604867]],
    [[13520145760351561049, 14628790721292608042, 9280862984646714284,
      16724360801538604867],
     [3995204376582206952, 18403327578336029129, 11805410055402518411,
      4600915536736799424]]]

# The reference package's host build at DEFAULT_PARAMS (poseidon_config(),
# FriConfig(), trees of height 32): each shape family's degree, gate keys,
# rows of each member and sha256 of each member's const_sigma_values
# (selectors, constants, sigmas; uint64 little-endian bytes, C order). The
# block parts' constant columns hold the families' fingerprints, which the
# reference derives only through the families' preprocessing (too slow on
# a host); its host build ran with stand-in fingerprints that keep the
# real ones' equalities (random felts: one aggregator and one dummy
# fingerprint per shape family, one leaf fingerprint per op; equal
# constants share a row), so the parts are pinned by degree, gate keys,
# rows and the sha256 of their selector and sigma columns, which the
# fingerprints' values do not change.
GOLDEN_ROLLUP_SHAPES = {
    "A": {"log_n": 16,
          "gates": ["arithmetic<8>", "base_sum<16>", "base_sum<62>",
                    "constant<2>", "poseidon", "public_input",
                    "reducing<26>", "reducing_ext<13>"],
          "rows": {"register": 201, "claim": 408, "transfer": 401,
                   "add_withdrawal": 404, "dummy": 4, "agg": 53967},
          "const_sigma_sha256": {
              "register": "103871812a01886853ab56c15991dec4"
                          "2e5b111d494c04f237eda08149a5bdc9",
              "claim": "86f24ace67e0518c9f0d8a612ec5ba89"
                       "899ea9398a3dbd32d59dde2e08999e95",
              "transfer": "9ae10a70d8de2ddd0d78ef0ebde481b5"
                          "1ed67ea0d7b27ea4c244d04e9e8a7b85",
              "add_withdrawal": "26bb61681ce5d6405dda4d1c649f4c24"
                                "a0ecf469c405f3af5a23239cfcab7c85",
              "dummy": "814c4943c8158d97ef26bce6ce0af301"
                       "6a859f562e504c985a73afccb91e281b",
              "agg": "46785cd46549864fe96e7d37df4f64f9"
                     "3741ccfa3cc050cacf211b968231975c"}},
    "B": {"log_n": 16,
          "gates": ["arithmetic<8>", "base_sum<16>", "constant<2>",
                    "poseidon", "public_input", "reducing<26>",
                    "reducing_ext<13>"],
          "rows": {"process_withdrawal": 200, "add_deposit": 202,
                   "dummy": 5, "agg": 53526},
          "const_sigma_sha256": {
              "process_withdrawal": "cfde9ebc1467d25c7ae10232ef43ea3c"
                                    "dd37dafbcb8d0a450dbd1050d5e40afa",
              "add_deposit": "0612f92ad13eb1415b0dd6b9aef884fc"
                             "a992ca58f5b77b103e72a47bb1516460",
              "dummy": "f92c0ba5d0c975204cc064dc79aec895"
                       "5004e4727e1406df8a7ee242d9169c60",
              "agg": "e1de15878403037e4cb5636960abafc1"
                     "853a08b664c217622aae059399dcb67c"}},
    "part1": {"log_n": 17, "rows": 80962,
              "gates": ["constant<2>", "poseidon", "arithmetic<8>",
                        "reducing_ext<13>", "base_sum<16>", "reducing<26>",
                        "public_input"],
              "sel_sigma_sha256": "bb95af32aea970418a684d76a07985b6"
                                  "2442988a6b4b5489acb3561b428bd112"},
    "part2": {"log_n": 17, "rows": 80527,
              "gates": ["constant<2>", "poseidon", "arithmetic<8>",
                        "reducing_ext<13>", "base_sum<16>", "reducing<26>",
                        "public_input"],
              "sel_sigma_sha256": "2d652564bcfdbfc0e8183dea98eaed74"
                                  "0e7b7069b4a375b099165add9610068a"},
}
# The rollup and sighash paths prove their circuits as the prove path does;
# K5 (the streamed commit) and the tail kernel (past 2^13 a row) stay at 0.
ROLLUP_KERNELS = PROVE_KERNELS
SIGHASH_KERNELS = PROVE_KERNELS


def block2_requests(om):
    """The second block, on top of the demo block: a register and two
    transfers (om: either package's rollup.orchestrator)."""
    return om.BlockRequests(
        register_users=[om.RegisterUser(3, (4, 4, 4, 4))],
        token_transfers=[om.TokenTransfer(0, 2, 40),
                         om.TokenTransfer(1, 3, 30)])


def holds_tensor(obj) -> bool:
    """Whether a proof (or any nest of dataclasses, lists, tuples and dicts)
    holds a torch tensor anywhere: a proof in the proof store must pickle
    without the device."""
    if isinstance(obj, torch.Tensor):
        return True
    if isinstance(obj, (list, tuple)):
        return any(holds_tensor(v) for v in obj)
    if isinstance(obj, dict):
        return any(holds_tensor(v) for v in obj.values())
    if hasattr(obj, "__dataclass_fields__"):
        return any(holds_tensor(getattr(obj, f))
                   for f in obj.__dataclass_fields__)
    return False


# The check and the items that in_forked_processes' workers run: set before
# they fork, so that they share them and nothing of them is pickled.
_FORKED = []


def _run_forked(i):
    """(check(items[i]), seconds) in a forked worker."""
    check, items = _FORKED[0]
    t0 = time.perf_counter()
    ok = check(items[i])
    return ok, time.perf_counter() - t0


def in_forked_processes(check, items, workers: int = 6) -> list:
    """[(check(item), seconds)] over items, in forked worker processes. For
    host work only (the host verifier is python ints and numpy): what it
    needs of the device, such as verifier data, is made before the fork.
    The pool is closed before this returns."""
    import gc
    import multiprocessing
    _FORKED[:] = [(check, items)]
    gc.freeze()                 # the workers' gc leaves the parent's pages
    try:
        with multiprocessing.get_context("fork").Pool(workers) as pool:
            return pool.map(_run_forked, range(len(items)), chunksize=1)
    finally:
        gc.unfreeze()
        _FORKED.clear()


def circuit_rows(data) -> int:
    """Rows of a built circuit that hold a gate."""
    return sum(r is not None for r in data.prover.rows)


def sha256_u64(a) -> str:
    import hashlib
    return hashlib.sha256(np.ascontiguousarray(a, dtype=np.uint64)
                          .tobytes()).hexdigest()


def sel_sigma_values(data) -> np.ndarray:
    """The selector and sigma rows of const_sigma_values (the constants
    between them left out)."""
    v = data.prover.const_sigma_values
    s = data.common.num_sel_cols
    k = data.common.config.num_constants
    return np.concatenate([v[:s], v[s + k:]])


def rollup_shape_differences(toolbox) -> list[str]:
    """What the toolbox's circuits do not reproduce of GOLDEN_ROLLUP_SHAPES
    (empty when all of it matches)."""
    bad = []
    for fam_key, fam in (("A", toolbox.family_a), ("B", toolbox.family_b)):
        want = GOLDEN_ROLLUP_SHAPES[fam_key]
        members = dict(fam.leaves)
        members.update(dummy=fam.dummy, agg=fam.agg)
        for name, built in members.items():
            d = built.data
            got = {"log_n": d.common.log_n,
                   "gates": [g.key for g in d.common.gates],
                   "rows": circuit_rows(d),
                   "sha": sha256_u64(d.prover.const_sigma_values)}
            for k, w in (("log_n", want["log_n"]), ("gates", want["gates"]),
                         ("rows", want["rows"][name]),
                         ("sha", want["const_sigma_sha256"][name])):
                if got[k] != w:
                    bad.append(f"family {fam_key} {name} {k}: {got[k]} "
                               f"!= {w}")
    for part in ("part1", "part2"):
        d = toolbox.block[part][0]
        want = GOLDEN_ROLLUP_SHAPES[part]
        got = {"log_n": d.common.log_n,
               "gates": [g.key for g in d.common.gates],
               "rows": circuit_rows(d),
               "sel_sigma_sha256": sha256_u64(sel_sigma_values(d))}
        bad += [f"{part} {k}: {got[k]} != {w}" for k, w in want.items()
                if got[k] != w]
    return bad


class ProveRecorder:
    """While entered, wraps the port's prover.prove_batch (which prove
    calls) so that each call made by the worker is recorded: circuit,
    batch, wall time on the host clock (the device synchronised at both
    ends), its steps (prove_batch's on_step), peak device memory, what
    was held before it and its proofs; with `launches` (the kernels'
    launch counts), the launches it made. `keep` (a CircuitData) also
    keeps the last wire matrix generated for that circuit."""

    def __init__(self, prover_mod, circuit_mod, keep=None, launches=None):
        self.prover = prover_mod
        self.circuit = circuit_mod
        self.keep = keep
        self.kept = None
        self.launches = launches
        self.calls = []

    def __enter__(self):
        self._batch = self.prover.prove_batch
        self._witness = self.prover.generate_witness

        def witness(data, pw):
            w = self._witness(data, pw)
            if data is self.keep:
                self.kept = w
            return w

        def prove_batch(data, pws, **kw):
            timer = StepTimer()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated() / 2**30
            before = dict(self.launches()) if self.launches else {}
            timer.start()
            t0 = timer.last
            proofs = self._batch(data, pws, on_step=timer, **kw)
            torch.cuda.synchronize()
            self.calls.append({
                "data": data, "batch": len(pws),
                "wall_s": time.perf_counter() - t0, "steps_s": timer.steps,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "held_before_gib": held, "proofs": proofs,
                "launches": {k: v - before[k]
                             for k, v in self.launches().items()}
                if self.launches else {}})
            return proofs

        self.prover.prove_batch = prove_batch
        self.prover.generate_witness = witness
        return self

    def __exit__(self, *exc):
        self.prover.prove_batch = self._batch
        self.prover.generate_witness = self._witness



class BuildRecorder:
    """While entered, records each CircuitBuilder.build of the port: the
    circuit and the host seconds from its builder's creation to the end of
    its build (the layout, the preprocessing of the inner circuits whose
    verifier data it holds as constants, the copy classes and sigmas)."""

    def __init__(self, circuit_mod):
        self.cls = circuit_mod.CircuitBuilder
        self.builds = []

    def __enter__(self):
        cls, builds = self.cls, self.builds
        self._init, self._build = cls.__init__, cls.build
        init, build = self._init, self._build

        def __init__(b, *args, **kw):
            b._made_at = time.perf_counter()
            init(b, *args, **kw)

        def build_(b, *args, **kw):
            data = build(b, *args, **kw)
            torch.cuda.synchronize()
            builds.append({"data": data,
                           "build_s": time.perf_counter() - b._made_at})
            return data

        cls.__init__, cls.build = __init__, build_
        return self

    def __exit__(self, *exc):
        self.cls.__init__, self.cls.build = self._init, self._build


class Groth16Recorder:
    """While entered, times groth16.setup (the wrap statement's trusted
    setup, run when SigHashToolbox builds it). `watch(toolbox)` wraps the
    toolbox's wrap_groth16 so that each wrap is recorded: its result and
    the seconds of its final-GL host verify, witness, prove and verify."""

    def __init__(self, groth16_mod, verifier_mod):
        self.g16, self.verifier = groth16_mod, verifier_mod
        self.setup_s = 0.0
        self.results = []

    def __enter__(self):
        self._setup = setup = self.g16.setup

        def timed_setup(*args, **kw):
            t = time.perf_counter()
            out = setup(*args, **kw)
            self.setup_s += time.perf_counter() - t
            return out

        self.g16.setup = timed_setup
        return self

    def __exit__(self, *exc):
        self.g16.setup = self._setup

    def watch(self, toolbox):
        g16, ver, wrap = self.g16, self.verifier, toolbox.wrap_groth16

        def timed_wrap(final_proof):
            times = {"gl_verify_s": 0.0, "prove_s": 0.0, "verify_s": 0.0}

            def timed(name, fn):
                def run(*args, **kw):
                    t = time.perf_counter()
                    out = fn(*args, **kw)
                    times[name] += time.perf_counter() - t
                    return out
                return run

            saved = g16.prove, g16.verify, ver.verify
            g16.prove = timed("prove_s", g16.prove)
            g16.verify = timed("verify_s", g16.verify)
            ver.verify = timed("gl_verify_s", ver.verify)
            t0 = time.perf_counter()
            try:
                res = wrap(final_proof)
            finally:
                g16.prove, g16.verify, ver.verify = saved
            times["wrap_s"] = time.perf_counter() - t0
            times["witness_s"] = times["wrap_s"] - times["gl_verify_s"] - \
                times["prove_s"] - times["verify_s"]
            self.results.append(dict(res, times=times))
            return res

        toolbox.wrap_groth16 = timed_wrap


class RpcCounter:
    """While entered, counts the JSON-RPC calls this process makes
    (services.rpc_common._raw_call: the provider's and rpc_call's)."""

    def __init__(self, rpc_mod):
        self.mod = rpc_mod
        self.calls = 0

    def __enter__(self):
        self._raw = raw = self.mod._raw_call

        def counted(*args, **kw):
            self.calls += 1
            return raw(*args, **kw)

        self.mod._raw_call = counted
        return self

    def __exit__(self, *exc):
        self.mod._raw_call = self._raw


class WireCounter:
    """While entered, counts the calls this process's netstore clients make
    and the hex characters of the values and messages they move (both
    ways: proofs, witnesses, queue messages)."""

    def __init__(self, netstore_mod):
        self.cls = netstore_mod._Conn
        self.calls = 0
        self.hex_bytes = 0

    def __enter__(self):
        self._call = call = self.cls.call

        def counted(conn, req):
            resp = call(conn, req)
            self.calls += 1
            self.hex_bytes += sum(len(d.get(k) or "") for d in (req, resp)
                                  for k in ("v", "msg"))
            return resp

        self.cls.call = counted
        return self

    def __exit__(self, *exc):
        self.cls.call = self._call


class ServiceProcess:
    """`python -m city_rollup_tpu_torch.cli <args>` (a service of the port's
    CLI) started from this checkout when made, so that it starts while the
    script works on; stopped when `fleet` (an ExitStack) closes. A thread
    reads its first line, {"listening": ...}, and the seconds it took."""

    def __init__(self, fleet, args):
        import os
        root = str(Path(__file__).resolve().parent)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        self.name = args[0]
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "city_rollup_tpu_torch.cli"] + args,
            cwd=root, env=env, stdout=subprocess.PIPE, text=True)
        fleet.callback(self.stop)
        self.line, self.start_s = None, None
        t0 = time.perf_counter()

        def read_first_line():
            self.line = self.proc.stdout.readline()
            self.start_s = time.perf_counter() - t0

        self._reader = threading.Thread(target=read_first_line, daemon=True)
        self._reader.start()

    def address(self, timeout_s: float = 120.0) -> str:
        """The address it listens on; raises if it exited first or said
        nothing within `timeout_s`."""
        self._reader.join(timeout_s)
        if self._reader.is_alive():
            raise AssertionError(f"{self.name} said nothing in {timeout_s} s")
        if not self.line:
            raise AssertionError(f"{self.name} exited ({self.proc.wait()}) "
                                 "before listening")
        return json.loads(self.line)["listening"]

    def stop(self):
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self._reader.join(30)
        self.proc.stdout.close()


# --- the block's L1 binding and user signatures (rollup/sighash_*.py,
# zk_signature.py, wallet.py) ----------------------------------------------
# Block 2 spends the dev covenant (btc.dev_spend_cfg(), btc.DEV_SCRIPT_BODY:
# the reference's development deployment, `cli sighash-corpus
# --dev-covenant`) from a previous block transaction holding this balance:
# one input, no deposits, no withdrawals, so one shape, gid (0, 0, 0, 0, 0).
SIGHASH_GID = (0, 0, 0, 0, 0)
COVENANT_BALANCE = 5_000_000
# The circuits SigHashToolbox builds for one shape, in build order, then
# the signature circuits (the ZK signature's inner circuit and wrapper, the
# transfer op that verifies the wrapper's proof).
SIGHASH_BUILDS = ("accelerator", "shape", "probe minifier", "minified",
                  "wrapper", "final GL", "zk inner", "zk wrapper",
                  "signed transfer")
SIGNER_SK = [11, 22, 33, 44]
OTHER_SK = [5, 6, 7, 8]
# any felts stand for a standalone op's allowed root (as in the tests)
SIGNED_ALLOWED_ROOT = (11, 12, 13, 14)
# Block 2 is finished by its Groth16 wrap, whose trusted setup runs from
# this seed (dev mode: a run can be repeated; anyone who knows the seed can
# forge proofs). The store hides a received job for STORE_VISIBILITY_S,
# longer than the longest batch of jobs the worker pops (no redelivery
# mid-drain); the orchestrator service awaits the block's completion for
# at most BLOCK2_TIMEOUT_S.
GROTH16_SEED = b"chip-smoke block 2"
STORE_VISIBILITY_S = 1800
BLOCK2_TIMEOUT_S = 600

# The reference package's host build at DEFAULT_PARAMS.config
# (poseidon_config(), FriConfig()) of the dev covenant's shape gid
# (0, 0, 0, 0, 0): degree, rows, gate keys and sha256 of the columns. The
# circuits after the accelerator hold an inner circuit's verifier data as
# constants, which the reference derives only through its jnp
# preprocessing (too slow on a host); its host build took random stand-ins
# there, so they are pinned by their selector and sigma columns, which
# those values do not change; the accelerator, with no such constant, by
# all its columns. The final GL verifies the block transition, a circuit
# of the rollup toolbox: the reference's build of it took a stand-in of
# the transition's common data (16 public inputs, 2^16, its gates as the
# port's toolbox builds them on the card, the parts it verifies being
# held by GOLDEN_ROLLUP_SHAPES).
GOLDEN_SIGHASH_SHAPES = {
    "accelerator": {
        "log_n": 17, "rows": 68512,
        "gates": ["constant<2>", "base_sum<8>", "arithmetic<8>",
                  "base_sum<16>", "base_sum<32>", "base_sum<2>",
                  "base_sum<3>", "base_sum<1>", "poseidon", "public_input"],
        "const_sigma_sha256": "f7ee2fed9e14b23df314cd7431b7c3d7"
                              "472140e5de08b364b733dd20ce85831b"},
    "shape": {
        "log_n": 16, "rows": 35964,
        "gates": ["constant<2>", "base_sum<8>", "arithmetic<8>", "poseidon",
                  "reducing_ext<13>", "base_sum<16>", "reducing<26>",
                  "base_sum<32>", "base_sum<2>", "base_sum<1>",
                  "base_sum<5>", "public_input"],
        "sel_sigma_sha256": "d1769408708e02bdfb54157cfcbc4907"
                            "834992cd0ddf0ec1e574546b24928670"},
    "minified": {
        "log_n": 15, "rows": 27099,
        "gates": ["arithmetic<8>", "base_sum<16>", "constant<2>", "poseidon",
                  "public_input", "reducing<26>", "reducing_ext<13>"],
        "sel_sigma_sha256": "c7480e711a55375c8955f3b468b2706f"
                            "710e130343238046f660055b78bcb815"},
    "wrapper": {
        "log_n": 15, "rows": 24766,
        "gates": ["constant<2>", "poseidon", "arithmetic<8>",
                  "reducing_ext<13>", "base_sum<16>", "reducing<26>",
                  "public_input"],
        "sel_sigma_sha256": "e7172697db15311123b07b084d3cd5b0"
                            "55f12f24f1c555136cc462e06d94828d"},
    "final GL": {
        "log_n": 16, "rows": 51583,
        "gates": ["constant<2>", "poseidon", "arithmetic<8>",
                  "reducing_ext<13>", "base_sum<16>", "reducing<26>",
                  "public_input"],
        "sel_sigma_sha256": "45eccd4d8f125b53ddfc9f7836bdb0c5"
                            "4b82c6af7817c17209c53877c81467a5"},
}


def shape_of(data) -> dict:
    """A built circuit's rows, degree, preprocessed width S and gate keys."""
    return {"rows": circuit_rows(data), "log_n": data.common.log_n,
            "S": data.prover.const_sigma_values.shape[0],
            "gates": [g.key for g in data.common.gates]}


def sighash_shape_differences(datas: dict) -> list[str]:
    """What the sighash circuits (`datas`: name -> CircuitData) do not
    reproduce of GOLDEN_SIGHASH_SHAPES (empty when all of it matches)."""
    bad = []
    for name, want in GOLDEN_SIGHASH_SHAPES.items():
        d = datas[name]
        got = {"log_n": d.common.log_n, "rows": circuit_rows(d),
               "gates": [g.key for g in d.common.gates]}
        if "const_sigma_sha256" in want:
            got["const_sigma_sha256"] = sha256_u64(
                d.prover.const_sigma_values)
        else:
            got["sel_sigma_sha256"] = sha256_u64(sel_sigma_values(d))
        bad += [f"{name} {k}: {got[k]} != {w}" for k, w in want.items()
                if got[k] != w]
    return bad


def rollup_phase(dev, all_launches, zero_launches, fleet):
    """The rollup's block pipeline at DEFAULT_PARAMS, on the card: the
    toolbox's circuits built and held against GOLDEN_ROLLUP_SHAPES, the
    sighash toolbox of block 2's shape and the signature circuits built
    and held against GOLDEN_SIGHASH_SHAPES, K1/K2, K3 and K4 held against
    their plain versions at all their shapes, then two blocks proved
    through the worker and finalized, block 2 with its L1 transaction (its
    sighash chain: introspection, wrapper, final GL), every job's proof
    host-verified, an aggregation over a changed child proof and a final
    GL with a wrong spend index refused; then two actions signed by a
    wallet and a transfer op that verifies a signature in-circuit proved,
    and refused under another key. Block 2 goes through the fleet's
    services (block2), finished by its Groth16 wrap, whose proof is checked
    and assembled into the block's L1 transaction; a signature is proved
    through the user-prover service. Every process and server it starts is
    stopped when `fleet` (an ExitStack) closes. Returns (the rollup JSON
    line, kernel
    times at its shapes, the rollup path's launches: the circuits'
    preprocessing and both blocks' rollup jobs, counted from 0 around
    each; the sighash path's: its circuits' preprocessing, block 2's
    sighash chain and the signatures)."""
    import dataclasses
    from city_rollup_tpu_torch import cli
    from city_rollup_tpu_torch.core import cuda_ntt as cn
    from city_rollup_tpu_torch.core import cuda_poseidon as cp
    from city_rollup_tpu_torch.core import ntt as tn
    from city_rollup_tpu_torch.crypto import felts as feltenc
    from city_rollup_tpu_torch.crypto import groth16
    from city_rollup_tpu_torch.crypto.qhashout import QHashOut
    from city_rollup_tpu_torch.rollup import btc, groth16_wrap, netstore
    from city_rollup_tpu_torch.rollup import op_circuits as oc
    from city_rollup_tpu_torch.rollup import orchestrator as om
    from city_rollup_tpu_torch.rollup.circuits import (
        DEFAULT_PARAMS, FAMILY_BY_AGG, FAMILY_BY_DUMMY, OP_NAME_BY_TYPE,
        SHAPE_BY_FAMILY, CircuitToolbox, decode_proof, decode_witness,
        encode_proof)
    from city_rollup_tpu_torch.rollup.city_store import CityStore
    from city_rollup_tpu_torch.rollup.job_id import CircuitType, JobID
    from city_rollup_tpu_torch.rollup.link import MemoryBTCLink
    from city_rollup_tpu_torch.rollup.netstore import (NetProofStore,
                                                       NetQueueHub)
    from city_rollup_tpu_torch.rollup.proof_store import MemoryProofStore
    from city_rollup_tpu_torch.rollup.queues import Q_NOTIFICATIONS, QueueHub
    from city_rollup_tpu_torch.rollup.sighash_toolbox import SigHashToolbox
    from city_rollup_tpu_torch.rollup.wallet import CityMemoryWallet
    from city_rollup_tpu_torch.rollup.worker import Worker
    from city_rollup_tpu_torch.rollup.zk_signature import (
        ZKSignatureWrapperCircuit, derive_public_key)
    from city_rollup_tpu_torch.services import rpc_common
    from city_rollup_tpu_torch.services.api_server import make_api_server
    from city_rollup_tpu_torch.services.orchestrator_service import (
        produce_one_block, wait_for_produce_block)
    from city_rollup_tpu_torch.services.provider import CityRpcProvider
    from city_rollup_tpu_torch.services.rpc_common import (JsonRpcError,
                                                           rpc_call)
    from city_rollup_tpu_torch.services.user_prover import \
        make_user_prover_server
    from city_rollup_tpu_torch.snark import circuit, prover, verifier
    from city_rollup_tpu_torch.snark.debug import check_witness

    params = DEFAULT_PARAMS
    cfg = params.config
    # block 2's store-server starts now, while the circuits build
    store_svc = ServiceProcess(fleet, [
        "store-server", "--port", "0", "--visibility-timeout",
        str(STORE_VISIBILITY_S)])
    counted = {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    def rand(shape):
        return card_felts(gen, shape)

    edge = [0, 1, P - 1, (1 << 32) - 1, 1 << 32, 1 << 63]

    def with_edges(x):
        """x with the edge values in its first columns, as main's."""
        for j, v in enumerate(edge[:x.shape[1]]):
            x[:, j] = v - (1 << 64) if v >= 1 << 63 else v
            if j < x.shape[0]:
                x[j, 64:128] = x[0, j]
        return x

    def add_counts(into=counted, less=None):
        """Add the launches since the counts were set to 0, less those
        of `less` (a path's own), to `into`."""
        less = less or {}
        for k, v in all_launches().items():
            into[k] = into.get(k, 0) + v - less.get(k, 0)

    # --- build: the families on the host, their preprocessing (the
    # fingerprints), the block circuits (the parts' preprocessing inside:
    # the transition verifies them with constant verifier data) ----------
    zero_launches()
    toolbox = CircuitToolbox(params, device=dev)
    build_s = {}
    for name, build in [
            ("family A", lambda: toolbox.family_a),
            ("family B", lambda: toolbox.family_b),
            ("families' preprocessing",
             lambda: [toolbox.family_fps(n) for n in SHAPE_BY_FAMILY]),
            ("block circuits", lambda: toolbox.block),
            ("transition preprocessing",
             lambda: toolbox.block["transition"][0].verifier)]:
        t0 = time.perf_counter()
        build()
        torch.cuda.synchronize()
        build_s[name] = time.perf_counter() - t0
        log(f"phase rollup build {name} {build_s[name]:.3f} s")
    toolbox.prewarm()
    add_counts()
    circuits = {}
    for fam_key, fam in (("A", toolbox.family_a), ("B", toolbox.family_b)):
        for name, built in list(fam.leaves.items()) + [
                ("dummy", fam.dummy), ("agg", fam.agg)]:
            circuits[f"{fam_key} {name}"] = built.data
    for part in ("part1", "part2", "transition"):
        circuits[part] = toolbox.block[part][0]
    shapes = {name: {"rows": circuit_rows(d), "log_n": d.common.log_n,
                     "S": d.prover.const_sigma_values.shape[0],
                     "gates": [g.key for g in d.common.gates]}
              for name, d in circuits.items()}
    for name, sh in shapes.items():
        log(f"rollup circuit {name}: {sh['rows']} rows, log_n "
            f"{sh['log_n']}, S = {sh['S']}, gates {sh['gates']}")
    wrong = rollup_shape_differences(toolbox)
    if wrong:
        raise AssertionError(f"rollup circuits differ from the "
                             f"reference's: {wrong[:6]}")
    log("check the rollup circuits (families A and B, block parts 1 and 2) "
        "equal GOLDEN_ROLLUP_SHAPES")

    # --- the sighash toolbox of block 2's shape (the dev covenant, the
    # transition's verifier data a constant of its final GL) and the
    # signature circuits, built on the card: the sighash path's first
    # launches (their preprocessing) ------------------------------------------
    spend_cfg, body = btc.dev_spend_cfg(), btc.DEV_SCRIPT_BODY
    gid = btc.SigHashGadgetId(*SIGHASH_GID)
    sig_counted = {}
    zero_launches()
    g16_rec = Groth16Recorder(groth16, verifier)
    with BuildRecorder(circuit) as brec:
        t0 = time.perf_counter()
        with g16_rec:
            sht = SigHashToolbox(cfg, spend_cfg, body, [gid],
                                 toolbox.block["transition"][0],
                                 with_groth16=True, groth16_seed=GROTH16_SEED,
                                 groth16_dev=True, device=dev)
        torch.cuda.synchronize()
        build_s["sighash toolbox"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        zkw = ZKSignatureWrapperCircuit.build(cfg, device=dev)
        signed_params = dataclasses.replace(params, sig_wrapper=zkw.data)
        sb = circuit.CircuitBuilder(cfg)
        _, signed_setter = oc.make_l2_transfer(sb, signed_params)
        signed_op = sb.build(device=dev)
        signed_op.verifier
        torch.cuda.synchronize()
        build_s["signature circuits"] = time.perf_counter() - t0
    add_counts(sig_counted)
    shape_sht = sht.shape_for(gid.to_felt())
    sig_datas = dict(zip(SIGHASH_BUILDS, [b["data"] for b in brec.builds]))
    for name, data in [("accelerator", shape_sht.circuit.accel.data),
                       ("shape", shape_sht.circuit.data),
                       ("minified", shape_sht.minifier.data),
                       ("wrapper", sht.wrapper.data),
                       ("final GL", sht.final_gl.data),
                       ("zk inner", zkw.inner.data),
                       ("zk wrapper", zkw.data),
                       ("signed transfer", signed_op)]:
        if sig_datas.get(name) is not data:
            raise AssertionError(f"the builds are not {SIGHASH_BUILDS}")
    sig_shapes = {}
    for name, b in zip(SIGHASH_BUILDS, brec.builds):
        sig_shapes[name] = dict(shape_of(b["data"]), build_s=b["build_s"])
        log(f"sighash circuit {name}: {sig_shapes[name]['rows']} rows, "
            f"log_n {sig_shapes[name]['log_n']}, S = "
            f"{sig_shapes[name]['S']}, gates {sig_shapes[name]['gates']}, "
            f"built in {b['build_s']:.3f} s")
    g16_rec.watch(sht)
    log(f"phase sighash build: toolbox {build_s['sighash toolbox']:.3f} s "
        f"(the Groth16 wrap's setup {g16_rec.setup_s:.3f} s of it, "
        f"{len(sht.groth16.r1cs.a_rows)} constraints), signature circuits "
        f"{build_s['signature circuits']:.3f} s; the "
        f"transition's gates "
        f"{shape_of(toolbox.block['transition'][0])['gates']}")
    wrong = sighash_shape_differences(sig_datas)
    if wrong:
        raise AssertionError(f"sighash circuits differ from the "
                             f"reference's: {wrong[:6]}")
    log("check the sighash circuits (accelerator, shape, minified shape, "
        "wrapper, final GL) equal GOLDEN_SIGHASH_SHAPES")
    sighash_ids = {id(sig_datas[n]) for n in SIGHASH_BUILDS[:6]}
    sighash_name = {id(d): n for n, d in sig_datas.items()}

    # --- K1/K2, K3, K4 against their plain versions at this path's shapes:
    # every committed matrix's intt and coset LDE (wires, Z and partial
    # products, quotient chunks, each circuit's constants/sigmas), the
    # quotient's coset_intt, the leaf widths over 2^19 and 2^20 leaves,
    # a Merkle level, a grinding batch. The kernel runs on the whole
    # matrix; the plain versions, slow, on 8 of its rows or 2^12 of its
    # leaves at each end (the edge values among them) ------------------------
    nc = cfg.num_challenges
    # the wires, Z and partial products, quotient chunks
    widths = {cfg.num_wires, nc * (1 + cfg.num_partial_products),
              nc * cfg.quotient_chunks}
    t0 = time.perf_counter()
    plain_s = []

    def slice_rows(x):
        return x[:8] if x.shape[0] <= 16 else torch.cat([x[:8], x[-8:]])

    def check_ntt(log_n, rows, mode, label):
        log_m = log_n + cfg.rate_bits
        log_in = log_n if mode != "coset_intt" else log_m
        log_t = log_n if mode == "intt" else log_m
        log_n2 = cn._split(log_t)
        x = with_edges(rand((rows, 1 << log_in)))
        pre = tn._coset_table(log_in, 7, dev) if mode == "coset_lde" \
            else None
        scale = None if mode == "coset_lde" else cn._table(
            "oscale", cn._out_scale, log_t,
            7 if mode == "coset_intt" else None, device=dev)
        where = f"({rows}, 2^{log_in}) {mode} {label}"
        y = cn._k1(x, log_t, log_n2, pre)
        tp = time.perf_counter()
        require_equal(slice_rows(y),
                      cn._k1_plain(slice_rows(x), log_t, log_n2, pre),
                      f"ntt_fourstep_tw {where}")
        y = with_edges(y.reshape(-1, min(128, y.shape[1]))).reshape(y.shape)
        reverse = mode != "coset_lde"
        require_equal(slice_rows(cn._k2(y, log_t, log_n2, 0, reverse,
                                         scale)),
                      cn._k2_plain(slice_rows(y), log_t, log_n2, 0, reverse,
                                   scale),
                      f"ntt_block {where}")
        plain_s.append(time.perf_counter() - tp)

    def check_sponge(n, cols, label):
        x = with_edges(rand((n, cols)))
        got = cp.sponge_t(x)
        ends = torch.cat([x[:, :4096], x[:, -4096:]], dim=1)
        tp = time.perf_counter()
        require_equal(torch.cat([got[:, :4096], got[:, -4096:]], dim=1),
                      cp.sponge_t_plain(ends),
                      f"poseidon_sponge n={n} at {cols} leaves ({label}, "
                      f"both ends)")
        plain_s.append(time.perf_counter() - tp)

    by_log_n = {}
    for name, sh in list(shapes.items()) + list(sig_shapes.items()):
        if name != "probe minifier":        # built, never proved
            by_log_n.setdefault(sh["log_n"], set()).add(sh["S"])
    for log_n, s_widths in sorted(by_log_n.items()):
        for rows in sorted(widths | s_widths):
            check_ntt(log_n, rows, "intt", "(rollup)")
            check_ntt(log_n, rows, "coset_lde", "(rollup)")
        check_ntt(log_n, nc, "coset_intt", "(rollup quotient)")
        for n in sorted(widths | s_widths):
            check_sponge(n, 1 << (log_n + cfg.rate_bits), "rollup")
        torch.cuda.empty_cache()
    level = with_edges(rand((4, 1 << 20)))
    require_equal(cp.reduce_level_t(level), cp.reduce_level_t_plain(level),
                  "poseidon_sponge level entry (4, 2^20) (rollup)")
    states = with_edges(rand((12, 1 << 17)))
    require_equal(cp.permute_t(states), cp.permute_t_plain(states),
                  "poseidon_permute (12, 2^17) (rollup grinding)")
    del level, states
    torch.cuda.empty_cache()
    log(f"phase rollup kernel checks {time.perf_counter() - t0:.3f} s "
        f"(plain versions {sum(plain_s):.3f} s)")

    # --- the blocks ----------------------------------------------------------
    def family_of(ct):
        for table in (OP_NAME_BY_TYPE, FAMILY_BY_DUMMY, FAMILY_BY_AGG):
            if ct in table:
                return table[ct]
        return None

    block_ct = {CircuitType.BLOCK_AGG_STATE_PART_1: "part1",
                CircuitType.BLOCK_AGG_STATE_PART_2: "part2",
                CircuitType.BLOCK_STATE_TRANSITION: "transition"}

    def record_jobs(block, jobs, calls):
        """Per-job lines from the worker's benchmarks and the recorder's
        prove_batch calls (one call per job, or one per batched group)."""
        out = []
        for (job, ms), call in zip(jobs, calls):
            steps = call["steps_s"]
            out.append({
                "block": block, "job": CircuitType(job.circuit_type).name,
                "rows": circuit_rows(call["data"]),
                "log_n": call["data"].common.log_n,
                "batch": call["batch"], "wall_s": call["wall_s"],
                "job_ms": ms,
                "witness_share": steps.get("witness", 0.0) / call["wall_s"],
                "steps_s": steps, "peak_gib": call["peak_gib"],
                "held_before_gib": call["held_before_gib"]})
            log(f"job {block} {out[-1]['job']} log_n {out[-1]['log_n']} "
                f"({out[-1]['rows']} rows, B = {call['batch']}): "
                f"{call['wall_s']:.3f} s, witness "
                f"{out[-1]['witness_share']:.3f}, peak "
                f"{call['peak_gib']:.3f} GiB ({call['held_before_gib']:.3f} "
                f"held)")
        return out

    sighash_ct = {CircuitType.SIGHASH_INTROSPECTION: "minified",
                  CircuitType.SIGHASH_WRAPPER: "wrapper",
                  CircuitType.SIGHASH_FINAL_GL: "final GL"}

    def verify_block(store, jobs, extra=()):
        """Every job's proof, and the (circuit name, proof) pairs of
        `extra`, through the port's host verifier, spread over worker
        processes; returns the seconds of each."""
        items = []
        for job, _ in jobs:
            proof = decode_proof(store.get_proof(job.output_proof_id()))
            if holds_tensor(proof):
                raise AssertionError("a stored proof holds a torch tensor")
            ct = CircuitType(job.circuit_type)
            items.append((ct.name, sighash_ct.get(ct), ct, proof))
        items += [(name, name, None, proof) for name, proof in extra]

        def check(item):
            _, sig_name, ct, proof = item
            if sig_name is not None:
                d = sig_datas[sig_name]
                return verifier.verify(proof, d.common, d.verifier)
            if ct in block_ct:
                return toolbox.verify_block_proof(block_ct[ct], proof)
            return toolbox.verify_family_proof(family_of(ct), proof)
        results = in_forked_processes(check, items)
        for (label, *_), (ok, _) in zip(items, results):
            if not ok:
                raise AssertionError(f"verify rejects the {label} proof")
        return [t for _, t in results]

    sighash_proves = {CircuitType.SIGHASH_INTROSPECTION:
                      ("accelerator", "shape", "minified"),
                      CircuitType.SIGHASH_WRAPPER: ("wrapper",),
                      CircuitType.SIGHASH_FINAL_GL: ("final GL",)}

    def record_sighash_jobs(sig_jobs, sig_calls):
        """Per-job lines of the sighash chain: the job's wall time (the
        worker's), the proves it made (circuit, rows, degree, wall time,
        witness seconds, peak device memory), its witness share and
        peak."""
        out = []
        for job, ms in sig_jobs:
            ct = CircuitType(job.circuit_type)
            names = sighash_proves[ct]
            mine = [c for c in sig_calls
                    if sighash_name[id(c["data"])] in names]
            if len(mine) != len(names):
                raise AssertionError(f"{ct.name}: proves {len(mine)} "
                                     f"circuits, not {names}")
            proves = [{"circuit": sighash_name[id(c["data"])],
                       "rows": circuit_rows(c["data"]),
                       "log_n": c["data"].common.log_n,
                       "wall_s": c["wall_s"],
                       "witness_s": c["steps_s"].get("witness", 0.0),
                       "steps_s": c["steps_s"], "peak_gib": c["peak_gib"],
                       "held_before_gib": c["held_before_gib"]}
                      for c in mine]
            wall = ms / 1e3
            out.append({"job": ct.name, "wall_s": wall,
                        "witness_share": sum(p["witness_s"]
                                             for p in proves) / wall,
                        "peak_gib": max(p["peak_gib"] for p in proves),
                        "proves": proves})
            log(f"job 2 {ct.name}: {wall:.3f} s, witness "
                f"{out[-1]['witness_share']:.3f}, peak "
                f"{out[-1]['peak_gib']:.3f} GiB; " + ", ".join(
                    f"{p['circuit']} log_n {p['log_n']} ({p['rows']} rows) "
                    f"{p['wall_s']:.3f} s" for p in proves))
        return out

    def check_final_gl_inputs(planned, store, old_bytes):
        """Each final-GL proof's public inputs: felt248 of the old city
        root and felt252 of the input's sighash, from the host."""
        for i, fin in enumerate(planned.sighash_final_jobs):
            proof = decode_proof(store.get_proof(fin.output_proof_id()))
            want = feltenc.hash256_to_felt248(old_bytes) + \
                feltenc.hash256_to_felt252(btc.sighash(
                    planned.block_tx, i, planned.covenant_script,
                    spend_cfg.sighash_type))
            if [int(x) for x in proof.public_inputs] != want:
                raise AssertionError(f"final GL {i}: public inputs "
                                     f"{proof.public_inputs} != {want}")

    city = CityStore(user_tree_height=params.user_tree_height,
                     deposit_tree_height=params.deposit_tree_height,
                     withdrawal_tree_height=params.withdrawal_tree_height)
    cli.demo_genesis(city, params)
    blocks, jobs_line, verify_s, sighash_jobs = [], [], {}, []
    keep = toolbox.family_a.agg.data
    services = {"start_s": {}}
    rpc_calls, wire = RpcCounter(rpc_common), WireCounter(netstore)
    fleet.enter_context(rpc_calls)
    fleet.enter_context(wire)
    # the query API over this process's CityStore (a thread) and the
    # rpc-server, which forwards queries to it, start before block 1
    store_addr = store_svc.address()
    host, port = store_addr.rsplit(":", 1)
    port = int(port)
    t = time.perf_counter()
    api = make_api_server(city, NetProofStore(host, port))
    api.start_background()
    fleet.callback(api.shutdown)
    services["start_s"]["api-server"] = time.perf_counter() - t
    node_svc = ServiceProcess(fleet, [
        "rpc-server", "--port", "0", "--store", store_addr, "--api-url",
        api.url])

    def block1():
        """The CLI's demo block in a MemoryProofStore, planned and drained
        by process_next_job in this process."""
        store, hub = MemoryProofStore(), QueueHub()
        orch = om.Orchestrator(city, store, hub, params=params)
        worker = Worker(toolbox, store, hub, sighash_toolbox=sht)
        planned = orch.plan_block(1, cli.demo_requests())
        orch.enqueue(planned)
        with ProveRecorder(prover, circuit, keep=keep,
                           launches=all_launches) as rec:
            while worker.process_next_job():
                pass
        if len(hub.queue(Q_NOTIFICATIONS)) != 1:
            raise AssertionError("block 1: no completion notification")
        return planned, rec, store, orch, worker

    def block2(l1):
        """Block 2 through the fleet's services: the port's store-server
        and rpc-server (subprocesses, started through its CLI), the query
        API (a thread, over this process's CityStore), the requests sent
        to the node, the orchestrator service (a thread: the produce-block
        command, the RPC queues flushed into the block, planned, enqueued
        and awaited) and a worker with the sighash toolbox over
        NetProofStore / NetQueueHub, in this process."""
        node_url = node_svc.address()
        for svc in (store_svc, node_svc):
            services["start_s"][svc.name] = svc.start_s
        provider = CityRpcProvider(node_url=node_url)
        services.update(store=store_addr, api=api.url, node=node_url,
                        provider=provider)
        t_ingress = time.perf_counter()
        want = block2_requests(om)
        for r in want.register_users:
            provider.register_user(r.user_id, r.public_key)
        for tr in want.token_transfers:
            provider.token_transfer(tr.from_user, tr.to_user, tr.value)
        refused = None
        try:
            provider.token_transfer(0, 2, 1, signature_proof="00" * 8)
        except JsonRpcError as e:
            refused = str(e)
        if refused is None:
            raise AssertionError("the node queues a signed transfer for a "
                                 "fleet without signature verification")
        services["refused_signed"] = refused
        t_produce = time.perf_counter()
        services["ingress_s"] = t_produce - t_ingress
        provider.produce_block()
        log(f"phase fleet: store-server {store_addr}, api server {api.url}, "
            f"rpc-server {node_url} (seconds from launch to listening, "
            f"started while the script worked on: "
            f"{json.dumps({k: round(v, 3) for k, v in services['start_s'].items()})}); "
            f"block 2's requests and produce-block sent to the node in "
            f"{services['ingress_s']:.3f} s, a signed transfer refused")
        orch = om.Orchestrator(city, NetProofStore(host, port),
                               NetQueueHub(host, port), params=params)
        result = {}

        def orchestrate():
            try:
                if not wait_for_produce_block(orch.hub, timeout_s=60):
                    raise AssertionError("no produce-block command came")
                planned, done = produce_one_block(
                    orch, orch.hub, 2, l1_context=l1,
                    timeout_s=BLOCK2_TIMEOUT_S)
                result["notified_s"] = time.perf_counter() - t_produce
                # the Groth16 wrap's output is in the store when the
                # notification has come
                result["g16_stored"] = [
                    orch.store.get_bytes(j.output_proof_id()) is not None
                    for j in planned.groth16_jobs]
                result.update(planned=planned, done=done)
            except BaseException as e:         # re-raised by the caller
                result["error"] = e

        th = threading.Thread(target=orchestrate, daemon=True)
        th.start()
        store, hub = NetProofStore(host, port), NetQueueHub(host, port)
        worker = Worker(toolbox, store, hub, sighash_toolbox=sht)
        with ProveRecorder(prover, circuit, keep=keep,
                           launches=all_launches) as rec:
            while th.is_alive():
                if not worker.process_ready_batch(max_batch=8):
                    time.sleep(0.25)
        th.join()
        if "error" in result:
            raise result["error"]
        planned = result["planned"]
        if not result["done"]:
            raise AssertionError("block 2: no completion notification in "
                                 f"{BLOCK2_TIMEOUT_S} s")
        if not planned.groth16_jobs or not all(result["g16_stored"]):
            raise AssertionError("block 2's completion notification came "
                                 "before its Groth16 wrap")
        services["block2_produce_to_notification_s"] = result["notified_s"]
        return planned, rec, store, orch, worker

    for block in (1, 2):
        zero_launches()
        t0 = time.perf_counter()
        l1 = None
        if block == 1:
            planned, rec, store, orch, worker = block1()
            drain, backend = "process_next_job", "memory"
        else:
            # block 2's L1 transaction spends the covenant that holds the
            # city root block 1 left, and is finished by its Groth16 wrap
            old_bytes = QHashOut(tuple(GOLDEN_BLOCK_ROOTS[1][0])) \
                .to_le_bytes()
            prev_tx = om.make_genesis_block_tx(spend_cfg, body, old_bytes,
                                               balance=COVENANT_BALANCE)
            l1 = om.L1BlockContext(spend_cfg=spend_cfg, script_body=body,
                                   prev_block_tx=prev_tx, deposit_txs=[],
                                   with_groth16=True)
            planned, rec, store, orch, worker = block2(l1)
            drain, backend = "process_ready_batch", "netstore"
        roots = [list(planned.start_city_root), list(planned.end_city_root)]
        if roots != GOLDEN_BLOCK_ROOTS[block - 1]:
            raise AssertionError(f"block {block}: city roots {roots} are "
                                 "not the reference's")
        if l1 is not None and [h.gadget_id() for h in planned.hints] != \
                [gid]:
            raise AssertionError(f"block 2's L1 transaction has the shapes "
                                 f"{[h.gadget_id() for h in planned.hints]}")
        benches = worker.benchmarks
        if len(benches) != planned.num_jobs:
            raise AssertionError(f"block {block}: {len(benches)} jobs "
                                 f"proved of {planned.num_jobs}")
        jobs = [(JobID.from_bytes(bytes.fromhex(b.job_id)), b.duration_ms)
                for b in benches]
        # the Groth16 wrap is host work (no prove_batch call, no
        # Goldilocks proof): it is checked below
        g16_jobs = [(j, ms) for j, ms in jobs if j.circuit_type ==
                    CircuitType.WRAP_FINAL_SIGHASH_PROOF_BLS12381]
        jobs = [(j, ms) for j, ms in jobs if j.circuit_type !=
                CircuitType.WRAP_FINAL_SIGHASH_PROOF_BLS12381]
        # the sighash chain's proves are the sighash path's (the
        # introspection job proves the accelerator, the shape circuit and
        # the minifier); one recorder call per other job, or per batched
        # group (its members share the call): process_ready_batch proves
        # its groups, then its single jobs, in the order of its benchmarks
        sig_calls = [c for c in rec.calls if id(c["data"]) in sighash_ids]
        sig_jobs = [(j, ms) for j, ms in jobs if j.circuit_type in sighash_ct]
        calls = []
        for call in rec.calls:
            if id(call["data"]) not in sighash_ids:
                calls += [call] * call["batch"]
        sig_launches = {}
        for c in sig_calls:
            for k, v in c["launches"].items():
                sig_launches[k] = sig_launches.get(k, 0) + v
        ok = orch.finalize(planned, toolbox)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        add_counts(counted, less=sig_launches)
        for k, v in sig_launches.items():
            sig_counted[k] = sig_counted.get(k, 0) + v
        if not ok:
            raise AssertionError(f"block {block}: finalize rejects the "
                                 "transition proof")
        final = decode_proof(store.get_proof(
            planned.final_job.output_proof_id()))
        if [list(final.public_inputs[0:4]),
                list(final.public_inputs[4:8])] != roots:
            raise AssertionError(f"block {block}: the transition proof's "
                                 "public inputs are not the city roots")
        jobs_line += record_jobs(
            block, [(j, ms) for j, ms in jobs
                    if j.circuit_type not in sighash_ct], calls)
        if l1 is not None:
            sighash_jobs = record_sighash_jobs(sig_jobs, sig_calls)
            check_final_gl_inputs(planned, store, old_bytes)
            l1_block, l1_orch = planned, orch
        groups = [c["batch"] for c in rec.calls
                  if id(c["data"]) not in sighash_ids]
        log(f"phase rollup block {block} ({planned.num_jobs} jobs, "
            f"{drain}, {backend} backend, prove_batch sizes {groups}) "
            f"{wall:.3f} s, finalize: {ok}")
        t0 = time.perf_counter()
        extra = [(sighash_name[id(c["data"])], c["proofs"][0])
                 for c in sig_calls if sighash_name[id(c["data"])] in
                 ("accelerator", "shape")]
        verify_s[block] = verify_block(store, jobs, extra)
        log(f"check verify accepts all {len(jobs) + len(extra)} proofs of "
            f"block {block} ({time.perf_counter() - t0:.3f} s in worker "
            f"processes, {sum(verify_s[block]):.3f} s of verifying)")
        blocks.append({"block": block, "jobs": planned.num_jobs,
                       "drain": drain, "backend": backend, "wall_s": wall,
                       "prove_batch_sizes": groups, "roots": roots,
                       "finalized": ok})
        if drain == "process_ready_batch" and max(groups) < 2:
            raise AssertionError("block 2 ran no prove_batch with B > 1")
    agg_witness = rec.kept             # block 2's transfer aggregation
    log("check blocks 1 and 2: the reference's city roots, "
        "finalized, the transition proofs' public inputs the roots; block "
        "2 (sent to the node, planned by the orchestrator service, drained "
        "over the networked store) proved a batch of more than one and its "
        "sighash chain, whose final-GL public inputs are the host's "
        "felt248 of the old root and felt252 of the sighash, and its "
        "Groth16 wrap, before its completion notification")

    # --- Groth16: the wrap's output in the store against the final-GL
    # proof's public inputs, the proof through the verifier, tampered
    # public inputs refused ----------------------------------------------------
    (g16_job, g16_ms), = g16_jobs
    raw_wrap = store.get_bytes(g16_job.output_proof_id())
    stored = json.loads(raw_wrap)
    fin_proof = decode_proof(store.get_proof(
        l1_block.sighash_final_jobs[0].output_proof_id()))
    pis = [int(x) for x in fin_proof.public_inputs]
    want_pub = [*groth16_wrap.pack_state(pis),
                groth16_wrap.binding_digest(pis, sht.final_fingerprint)]
    if [int(x) for x in stored["public_inputs"]] != want_pub:
        raise AssertionError(f"the Groth16 wrap's public inputs "
                             f"{stored['public_inputs']} != {want_pub}")
    wrapped, = g16_rec.results
    if wrapped["proof"].to_city_data() != stored["proof_data"] or \
            [len(bytes.fromhex(v)) for v in stored["proof_data"].values()] \
            != [48] * 4:
        raise AssertionError("the stored Groth16 proof data is not the "
                             "wrap's four 48-byte fields")
    t = time.perf_counter()
    if not groth16.verify(sht.groth16.vk, want_pub, wrapped["proof"]):
        raise AssertionError("groth16.verify rejects the block's wrap")
    g16_check_s = time.perf_counter() - t
    for i in range(3):
        bad = list(want_pub)
        bad[i] ^= 1
        if groth16.verify(sht.groth16.vk, bad, wrapped["proof"]):
            raise AssertionError(f"groth16.verify accepts the wrap with "
                                 f"public input {i} changed")
    r1cs = sht.groth16.r1cs
    groth16_line = {
        "constraints": len(r1cs.a_rows), "variables": r1cs.num_vars,
        "public_inputs": r1cs.num_public, "setup_s": g16_rec.setup_s,
        "job_s": g16_ms / 1e3, **wrapped["times"],
        "check_verify_s": g16_check_s}
    log(f"check the Groth16 wrap ({len(r1cs.a_rows)} constraints; setup "
        f"{g16_rec.setup_s:.3f} s, the job {g16_ms / 1e3:.3f} s: final-GL "
        f"host verify {wrapped['times']['gl_verify_s']:.3f} s, prove "
        f"{wrapped['times']['prove_s']:.3f} s, verify "
        f"{wrapped['times']['verify_s']:.3f} s): its public inputs are the "
        f"host's pack_state and binding_digest of the final GL's, "
        f"groth16.verify accepts it ({g16_check_s:.3f} s) and rejects each "
        f"public input changed")

    # --- L1: the block transaction assembled from the wrap ------------------
    link = MemoryBTCLink()
    refusal = None
    try:
        l1_orch.assemble_l1_transaction(l1_block, link=link)
    except RuntimeError as e:
        refusal = str(e)
    if refusal is None or "refusing to broadcast" not in refusal:
        raise AssertionError("assemble_l1_transaction broadcasts without a "
                             "dev-mode flag")
    groth16_wrap.GROTH16_WRAP_ATTESTATION_DEV_MODE = True
    try:
        block_tx = l1_orch.assemble_l1_transaction(l1_block, link=link)
    finally:
        groth16_wrap.GROTH16_WRAP_ATTESTATION_DEV_MODE = False
    script = block_tx.inputs[0].script
    if script[0] != 48 or script[1:49] != bytes.fromhex(
            stored["proof_data"]["pi_a"]) or not script.endswith(
            btc.push_data(l1_block.covenant_script)):
        raise AssertionError("the block transaction's input script is not "
                             "the wrap's pushes and the covenant script")
    if link.get_transaction(block_tx.txid()) is not block_tx or \
            btc.BTCTransaction.parse(block_tx.serialize()).txid() != \
            block_tx.txid():
        raise AssertionError("the link does not hold the block transaction")
    log(f"check assemble_l1_transaction: refused without a dev-mode flag; "
        f"with GROTH16_WRAP_ATTESTATION_DEV_MODE the block transaction "
        f"({len(block_tx.serialize())} bytes, input script "
        f"{len(script)} bytes: the wrap's pushes, the covenant script) is "
        f"broadcast on the MemoryBTCLink")

    # --- queries through the node, forwarded to the api server --------------
    provider = services.pop("provider")
    if provider.get_city_root(2) != GOLDEN_BLOCK_ROOTS[1][1]:
        raise AssertionError("the api server's city root of block 2 is not "
                             "the reference's")
    if provider.get_proof_store_value(g16_job.output_proof_id().hex()) != \
            raw_wrap.hex():
        raise AssertionError("the api server's Groth16 output is not the "
                             "worker's")
    log("check the node, forwarding to the api server, answers block 2's "
        "city root and the Groth16 job's stored output")

    # --- refused: a final GL whose spend index is not the wrapper's --------
    t0 = time.perf_counter()
    tr_proof = decode_proof(store.get_proof(
        l1_block.final_job.output_proof_id()))
    wr_job = next(j for j, _ in sig_jobs
                  if j.circuit_type == int(CircuitType.SIGHASH_WRAPPER))
    wr_proof = decode_proof(store.get_proof(wr_job.output_proof_id()))
    refused = None
    try:
        sht.prove_final(tr_proof, wr_proof, {
            "cur_bal": COVENANT_BALANCE,
            "next_bal": l1_block.block_tx.outputs[0].value, "spend_idx": 1})
    except ValueError as e:
        refused = str(e)
    if refused is None:
        raise AssertionError("a final GL with spend index 1 for 0 proves")
    refuse_s = time.perf_counter() - t0
    log(f"check a final GL with spend index 1 for 0: no witness "
        f"({refused[:60]}...) ({refuse_s:.3f} s)")

    # --- tampering: the transfer aggregation of block 2 over a child proof
    # with one wire opening changed -------------------------------------------
    t0 = time.perf_counter()
    agg_job = next(j for j, _ in jobs if j.circuit_type ==
                   int(CircuitType.AGG_L2_TRANSFER))
    w = decode_witness(store.get_bytes(agg_job.input_witness_id()))
    children = [(decode_proof(store.get_proof(JobID.from_bytes(
        bytes.fromhex(ch)).output_proof_id())), kind,
        (tuple(sp["start"]), tuple(sp["end"])))
        for ch, kind, sp in zip(w["children"], w["child_kinds"],
                                w["child_spans"])]
    agg_proof = decode_proof(store.get_proof(agg_job.output_proof_id()))
    pi_hash = prover.public_inputs_hash(agg_proof.public_inputs)
    tampered = copy.deepcopy(children[0][0])
    w0 = tampered.openings.wires[0]
    tampered.openings.wires[0] = ((w0[0] + 1) % P, w0[1])
    data, pw = toolbox.prepare_agg(
        "transfer", [(tampered,) + children[0][1:], children[1]])
    try:
        circuit.generate_witness(data, pw)
        raise AssertionError("an aggregation over a tampered child proof "
                             "completes into a witness")
    except ValueError as e:
        conflict = str(e)
    target = toolbox.family_a.agg.targets["sides"][0]["pt"] \
        .openings.wires[0][0]
    forged = with_target_value(data, agg_witness, target,
                               tampered.openings.wires[0][0])
    violations = check_witness(data, forged, pi_hash)
    if not violations:
        raise AssertionError("check_witness accepts the aggregation "
                             "witness of a tampered child proof")
    tamper_s = time.perf_counter() - t0
    log(f"check a changed child wire opening: no aggregation witness "
        f"({conflict[:60]}...), and check_witness reports "
        f"{len(violations)} violated constraints on the forged one, the "
        f"first {violations[0][:60]} ({tamper_s:.3f} s)")
    del agg_witness, forged

    # --- signatures: a wallet over the ZK wrapper signs a transfer and a
    # withdrawal; the transfer op that verifies the wrapper's proof
    # in-circuit proves the first, and gives no witness with the sender's
    # leaf under another key (the sighash path's last launches) --------------
    zero_launches()
    t0 = time.perf_counter()
    wallet = CityMemoryWallet.new_fast_setup(wrapper=zkw)
    pk = wallet.zk.add_zk_private_key(SIGNER_SK)
    addr = (7, 8, 9)
    actions = {"transfer": om.transfer_action_hash(signed_params, 0, 1, 1,
                                                   250),
               "withdrawal": om.withdrawal_action_hash(signed_params, 0, 2,
                                                       addr, 60)}
    sigs, sign_s = {}, {}
    for name, action in actions.items():
        t1 = time.perf_counter()
        sigs[name] = wallet.zk.sign(pk, action)
        torch.cuda.synchronize()
        sign_s[name] = time.perf_counter() - t1
        if sigs[name].public_inputs != list(pk) + list(action):
            raise AssertionError(f"the wallet's {name} signature does not "
                                 "sign its action")

    def signed_transfer_witness(sender_pk):
        """The transfer's stored witness from a one-transfer plan on a
        scratch CityStore whose sender holds `sender_pk`."""
        c = CityStore(user_tree_height=params.user_tree_height,
                      deposit_tree_height=params.deposit_tree_height,
                      withdrawal_tree_height=params.withdrawal_tree_height)
        c.register_user(0, 0, tuple(sender_pk))
        c.register_user(0, 1, (2, 2, 2, 2))
        c.increment_user_balance(0, 0, 1_000)
        st = MemoryProofStore()
        plan = om.Orchestrator(c, st, QueueHub(), params=signed_params) \
            .plan_block(1, om.BlockRequests(token_transfers=[
                om.TokenTransfer(0, 1, 250, signature_proof=encode_proof(
                    sigs["transfer"]).hex())]))
        job = next(j for j in plan.leaf_jobs if j.circuit_type ==
                   int(CircuitType.OP_L2_TRANSFER))
        w = decode_witness(st.get_bytes(job.input_witness_id()))
        return dict(w, signature_proof=decode_proof(bytes.fromhex(
            w["signature_proof"])), allowed_root=SIGNED_ALLOWED_ROOT)

    pw = sb.partial_witness()
    signed_setter(pw, signed_transfer_witness(pk))
    t1 = time.perf_counter()
    with ProveRecorder(prover, circuit) as srec:
        signed_proof = prover.prove(signed_op, pw)
    signed_prove_s = time.perf_counter() - t1
    # the user-prover service over the same ZK wrapper (a thread of this
    # process; its worker thread proves on the card): the public key, the
    # withdrawal action signed through cr_proveZkSignature / cr_getProof,
    # the same job id for the same request
    t1 = time.perf_counter()
    up = make_user_prover_server(zkw)
    up.start_background()
    fleet.callback(up.shutdown)
    services["start_s"]["user-prover"] = time.perf_counter() - t1
    if rpc_call(up.url, "cr_getZkPublicKey", [SIGNER_SK]) != \
            derive_public_key(SIGNER_SK):
        raise AssertionError("the user prover's public key is not "
                             "derive_public_key's")
    action = [int(x) for x in actions["withdrawal"]]
    t1 = time.perf_counter()
    up_job = rpc_call(up.url, "cr_proveZkSignature", [SIGNER_SK, action])
    while (st := rpc_call(up.url, "cr_getProof", [up_job]))["status"] == \
            "pending":
        if time.perf_counter() - t1 > 600:
            raise AssertionError("the user prover took over 600 s")
        time.sleep(0.1)
    up_s = time.perf_counter() - t1
    if st["status"] != "done":
        raise AssertionError(f"the user prover failed: {st}")
    up_proof = decode_proof(bytes.fromhex(st["proof"]))
    if list(up_proof.public_inputs) != list(pk) + action:
        raise AssertionError("the user prover's proof does not sign pk || "
                             "the withdrawal action")
    if rpc_call(up.url, "cr_proveZkSignature", [SIGNER_SK, action]) != \
            up_job:
        raise AssertionError("the same request to the user prover makes "
                             "another job")
    services["user_prover_sign_s"] = up_s
    checks = [(f"the wallet's {name} signature", zkw.data, proof)
              for name, proof in sigs.items()]
    checks.append(("the signed transfer's proof", signed_op, signed_proof))
    checks.append(("the user prover's signature", zkw.data, up_proof))
    for (what, *_), (ok, _) in zip(checks, in_forked_processes(
            lambda c: verifier.verify(c[2], c[1].common, c[1].verifier),
            checks)):
        if not ok:
            raise AssertionError(f"verify rejects {what}")
    wrong_key = None
    try:
        pw = sb.partial_witness()
        signed_setter(pw, signed_transfer_witness(
            derive_public_key(OTHER_SK)))
        circuit.generate_witness(signed_op, pw)
    except ValueError as e:
        wrong_key = str(e)
    if wrong_key is None:
        raise AssertionError("a transfer signed under another key than the "
                             "sender's completes into a witness")
    torch.cuda.synchronize()
    add_counts(sig_counted)
    signatures_s = time.perf_counter() - t0
    signatures = {
        "zk_wrapper": {k: sig_shapes["zk wrapper"][k]
                       for k in ("rows", "log_n")},
        "sign_s": sign_s,
        "signed_transfer": {
            k: sig_shapes["signed transfer"][k] for k in ("rows", "log_n")},
        "prove_s": signed_prove_s,
        "witness_share": srec.calls[0]["steps_s"].get("witness", 0.0) /
        srec.calls[0]["wall_s"], "peak_gib": srec.calls[0]["peak_gib"],
        "phase_s": signatures_s}
    log(f"check signatures: the wallet's transfer and withdrawal signatures "
        f"verify ({sign_s['transfer']:.3f} and {sign_s['withdrawal']:.3f} "
        f"s to sign); the signed transfer (log_n "
        f"{signatures['signed_transfer']['log_n']}, "
        f"{signatures['signed_transfer']['rows']} rows) proves in "
        f"{signed_prove_s:.3f} s and verifies; under another key: no "
        f"witness ({wrong_key[:60]}...); the user-prover service signs the "
        f"withdrawal ({up_s:.3f} s), its proof verifies, the same request "
        f"gives the same job ({signatures_s:.3f} s)")

    # --- kernel times at this path's shapes (B = 1: 2^14 to 2^17 rows) ------
    kernel_times = []
    for log_n in sorted(by_log_n):
        log_m = log_n + cfg.rate_bits
        x = rand((cfg.num_wires, 1 << log_n))
        q = rand((nc, 1 << log_m))
        for label, fn, rows, n_in, n_out in [
                ("wires intt", lambda: tn.intt(x, log_n), cfg.num_wires,
                 1 << log_n, 1 << log_n),
                ("wires coset_lde",
                 lambda: tn.coset_lde(x, log_n, cfg.rate_bits),
                 cfg.num_wires, 1 << log_n, 1 << log_m),
                ("quotient coset_intt", lambda: tn.coset_intt(q, log_m), nc,
                 1 << log_m, 1 << log_m)]:
            ms = cuda_ms(fn, 10)
            bound, fourstep = ntt_pair_bounds_ms(rows, n_in, n_out)
            kernel_times.append({
                "name": "ntt_fourstep_tw + ntt_block", "what": label,
                "shape": [[rows, n_in], [rows, n_out]], "ms": ms,
                "bound_ms": bound, "bound_by": "bytes",
                "fourstep_bytes_ms": fourstep})
            log(f"time rollup {label} ({rows}, {n_in}) -> ({rows}, "
                f"{n_out}): {ms:.4f} ms, byte bound {bound:.4f} ms")
        del x, q
        for label, n in [("wires", cfg.num_wires),
                         ("constants/sigmas", max(by_log_n[log_n]))]:
            y = rand((n, 1 << log_m))
            t_bytes = 8 * (n + 4) * (1 << log_m) / MEM_BYTES_PER_S * 1e3
            t_ops = -(-n // 8) * OPS_PERMUTATION * (1 << log_m) / \
                OPS_PER_S * 1e3
            torch.cuda.synchronize()
            t = time.perf_counter()
            cp.sponge_t_plain(y)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t) * 1e3
            ms = cuda_ms(lambda: cp.sponge_t(y), 5)
            kernel_times.append({
                "name": "poseidon_sponge", "what": f"{label} leaves",
                "shape": [n, 1 << log_m], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
            log(f"time rollup poseidon_sponge {label} leaves ({n}, "
                f"{1 << log_m}): {ms:.4f} ms, plain {plain_ms:.1f} ms, "
                f"bound {max(t_bytes, t_ops):.4f} ms")
            del y
        torch.cuda.empty_cache()

    line = {"circuits": shapes, "build_s": build_s, "blocks": blocks,
            "jobs": jobs_line,
            "verify_s": {str(k): v for k, v in verify_s.items()},
            "tamper_s": tamper_s, "launches": counted,
            "sighash": {"gid": list(SIGHASH_GID), "circuits": sig_shapes,
                        "jobs": sighash_jobs, "refuse_s": refuse_s,
                        "launches": sig_counted},
            "signatures": signatures, "groth16": groth16_line,
            "services": dict(services, rpc_calls=rpc_calls.calls,
                             store_calls=wire.calls,
                             store_hex_bytes=wire.hex_bytes)}
    return line, kernel_times, counted, sig_counted


# The parallel path (torch.distributed, world size 1 on one card): one
# polynomial's coset LDE + commit at the FRI codeword scale (degree 2^20 ->
# 2^23 points, leaves of PARALLEL_LEAF_WIDTH consecutive values, cap 2^4),
# BASELINE's config 2 (64 polynomials of 2^20) as a batched LDE and a
# sharded cap, and one NTT of 2^23. It runs the local transforms (K1, K2)
# and the leaf hashes and tree levels (K4); its caps never go through
# two_to_one (K3).
PARALLEL_LOG_N = 20
PARALLEL_LEAF_WIDTH = 8
PARALLEL_POLYS = 64
PARALLEL_NTT_LOG_N = 23
PARALLEL_KERNELS = ("ntt_fourstep_tw", "ntt_block", "poseidon_sponge")


def parallel_phase(dev, all_launches, zero_launches, prove_data, prove_pws,
                   prove_plain, prove_s):
    """The parallel path on the card at world size 1 (NCCL; the rendezvous
    a FileStore in a temporary directory): K1/K2 and K4 held against their
    plain versions at the path's shapes and timed there, the single-device
    results made,
    then the group set up and, with every launch count set to 0,
    dist_lde_commit, dist_batched_coset_lde then dist_merkle_cap, dist_ntt
    and prove_batch(mesh=) of the prove path's full-width circuit at B =
    PROVE_BATCH (the prove phase's witnesses); each result held bit for bit
    against the single-device one, the proofs field for field against the
    prove phase's batch (prove_plain, proved in prove_s). With one rank the
    all-to-alls and gathers are local copies. The group is destroyed at the
    end, on failure too. Returns (the parallel JSON line, the path's
    launches)."""
    import datetime
    import os
    import tempfile

    import torch.distributed as dist
    from city_rollup_tpu_torch import convert, pipeline
    from city_rollup_tpu_torch.core import cuda_ntt as cn
    from city_rollup_tpu_torch.core import cuda_poseidon as cp
    from city_rollup_tpu_torch.core import merkle
    from city_rollup_tpu_torch.core import ntt as tn
    from city_rollup_tpu_torch.parallel import (dist_merkle, dist_ntt,
                                                dist_pipeline)
    from city_rollup_tpu_torch.parallel import mesh as mesh_mod
    from city_rollup_tpu_torch.snark import prover

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)

    def rand(shape):
        return card_felts(gen, shape)

    def ends(x, n, dim):
        """The first and last n entries of x along dim."""
        return torch.cat([x.narrow(dim, 0, n),
                          x.narrow(dim, x.shape[dim] - n, n)], dim=dim)

    log_n, log_m = PARALLEL_LOG_N, PARALLEL_LOG_N + RATE_BITS
    log_r, log_c = dist_ntt._split_logs(log_m)
    if dist_ntt._split_logs(PARALLEL_NTT_LOG_N) != (log_r, log_c):
        raise AssertionError("the parallel path's transforms differ in shape")

    # --- K1/K2 and K4 at the path's shapes: each kernel on the whole input,
    # its plain version on the first and last 8 rows (K1, K2) or 4096
    # columns (K4) ------------------------------------------------------------
    t0 = time.perf_counter()
    for log_t, rows, log_in, pre, what in [
            (log_r, 1 << log_c, log_r, None, "column NTTs"),
            (log_c, 1 << log_r, log_c, None, "row NTTs"),
            (log_m, PARALLEL_POLYS, log_n,
             tn._coset_table(log_n, 7, dev), "batched coset LDE")]:
        x = rand((rows, 1 << log_in))
        x[:, 0], x[:, 1], x[:, 2] = 0, P - 1 - (1 << 64), 1 << 32
        log_n2 = cn._split(log_t)
        where = f"({rows}, 2^{log_in}) -> 2^{log_t} (parallel {what})"
        y = cn._k1(x, log_t, log_n2, pre)
        require_equal(ends(y, 8, 0),
                      cn._k1_plain(ends(x, 8, 0), log_t, log_n2, pre),
                      f"ntt_fourstep_tw {where}")
        require_equal(ends(cn._k2(y, log_t, log_n2), 8, 0),
                      cn._k2_plain(ends(y, 8, 0), log_t, log_n2),
                      f"ntt_block {where}")
        del x, y
    for n, cols, what in [
            (PARALLEL_LEAF_WIDTH, (1 << log_m) // PARALLEL_LEAF_WIDTH,
             "LDE + commit leaves"),
            (PARALLEL_POLYS, 1 << log_m, "sharded cap leaves")]:
        x = rand((n, cols))
        require_equal(ends(cp.sponge_t(x), 4096, 1),
                      cp.sponge_t_plain(ends(x, 4096, 1)),
                      f"poseidon_sponge n={n} at {cols} leaves (parallel "
                      f"{what}, both ends)")
    level = rand((4, 1 << log_m))
    got = cp.reduce_level_t(level)
    require_equal(ends(got, 4096, 1),
                  torch.cat([cp.reduce_level_t_plain(level[:, :8192]),
                             cp.reduce_level_t_plain(level[:, -8192:])], 1),
                  f"poseidon_sponge level entry (4, 2^{log_m}) (parallel, "
                  f"both ends)")
    del x, level, got
    # their times at those shapes: K1 + K2 as the local transforms, against
    # the transform's byte bound; K4 on both leaf matrices (the plain
    # version timed on the smaller)
    kernel_times = []
    for rows, log_t, what in [(1 << log_c, log_r, "column NTTs"),
                              (1 << log_r, log_c, "row NTTs")]:
        x = rand((rows, 1 << log_t))
        ms = cuda_ms(lambda: tn.ntt(x, log_t), 20)
        bound, fourstep = ntt_pair_bounds_ms(rows, 1 << log_t, 1 << log_t)
        kernel_times.append({
            "name": "ntt_fourstep_tw + ntt_block", "what": what,
            "shape": [rows, 1 << log_t], "ms": ms, "bound_ms": bound,
            "bound_by": "bytes", "fourstep_bytes_ms": fourstep})
        log(f"time parallel {what} ntt ({rows}, 2^{log_t}): {ms:.4f} ms, "
            f"byte bound {bound:.4f} ms (four-step {fourstep:.4f} ms)")
    for n, cols, what, time_plain in [
            (PARALLEL_LEAF_WIDTH, (1 << log_m) // PARALLEL_LEAF_WIDTH,
             "LDE + commit leaves", True),
            (PARALLEL_POLYS, 1 << log_m, "sharded cap leaves", False)]:
        x = rand((n, cols))
        t_bytes = 8 * (n + 4) * cols / MEM_BYTES_PER_S * 1e3
        t_ops = -(-n // 8) * OPS_PERMUTATION * cols / OPS_PER_S * 1e3
        plain_ms = None
        if time_plain:
            torch.cuda.synchronize()
            t = time.perf_counter()
            cp.sponge_t_plain(x)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t) * 1e3
        ms = cuda_ms(lambda: cp.sponge_t(x), 5)
        kernel_times.append({
            "name": "poseidon_sponge", "what": what, "shape": [n, cols],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
        log(f"time parallel poseidon_sponge {what} ({n}, {cols}): {ms:.4f} "
            f"ms, plain {plain_ms} ms, bound {max(t_bytes, t_ops):.4f} ms")
    del x
    torch.cuda.empty_cache()
    log(f"phase parallel kernel checks and times "
        f"{time.perf_counter() - t0:.3f} s")

    # --- the single-device results, before the group -------------------------
    c_one = rand((1 << log_n,))
    c_polys = rand((PARALLEL_POLYS, 1 << log_n))
    c_ntt = rand((1 << PARALLEL_NTT_LOG_N,))

    def single_lde_commit():
        lde = tn.coset_lde(c_one, log_n, RATE_BITS)
        return lde, merkle.MerkleTree(lde.reshape(-1, PARALLEL_LEAF_WIDTH),
                                      CAP_HEIGHT).cap

    # name -> (what, the single-device call); each returns (LDE or
    # evaluations, cap or None)
    calls = {
        "dist_lde_commit": (
            f"coset LDE 2^{log_n} -> 2^{log_m} + cap of "
            f"{PARALLEL_LEAF_WIDTH}-value leaves (coset_lde + MerkleTree)",
            single_lde_commit),
        "dist_batched_coset_lde + dist_merkle_cap": (
            f"({PARALLEL_POLYS}, 2^{log_n}) coset LDE + cap (coset_lde, "
            f"lde_commit)",
            lambda: (tn.coset_lde(c_polys, log_n, RATE_BITS),
                     pipeline.lde_commit(c_polys, log_n=log_n,
                                         rate_bits=RATE_BITS,
                                         cap_height=CAP_HEIGHT,
                                         device=dev))),
        "dist_ntt": (f"ntt 2^{PARALLEL_NTT_LOG_N} (ntt)",
                     lambda: (tn.ntt(c_ntt, PARALLEL_NTT_LOG_N), None))}
    single, single_s = {}, {}
    for name, (_, fn) in calls.items():
        times = []
        for _ in range(2):                  # first call, then warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            single[name] = fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        single_s[name] = times

    # --- the group, then the path once, counted ------------------------------
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
            world_size=1, timeout=datetime.timedelta(seconds=300))
        try:
            mesh = mesh_mod.make_mesh(1, device=dev)
            # the first collective sets the communicator up
            mesh_mod.gather(mesh, torch.zeros(1, dtype=torch.int64,
                                              device=dev))
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            backend = str(dist.get_backend())
            world = mesh_mod.size(mesh)
            log(f"phase parallel group setup ({backend}, world size {world}) "
                f"{setup_s:.6f} s")

            def lde_commit():
                cap, lde = dist_pipeline.dist_lde_commit(
                    mesh, c_one, log_n, RATE_BITS, PARALLEL_LEAF_WIDTH,
                    CAP_HEIGHT)
                return lde, cap

            def lde_cap():
                lde = dist_ntt.dist_batched_coset_lde(mesh, c_polys, log_n,
                                                      RATE_BITS)
                leaves = mesh_mod.gather(mesh, lde).T     # (2^log_m, 64)
                return lde, dist_merkle.dist_merkle_cap(mesh, leaves,
                                                        CAP_HEIGHT)

            dist_calls = {
                "dist_lde_commit": lde_commit,
                "dist_batched_coset_lde + dist_merkle_cap": lde_cap,
                "dist_ntt": lambda: (dist_ntt.dist_ntt(
                    mesh, c_ntt, PARALLEL_NTT_LOG_N), None)}
            zero_launches()
            torch.cuda.reset_peak_memory_stats()
            got, dist_s = {}, {}
            for name, fn in dist_calls.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got[name] = fn()
                torch.cuda.synchronize()
                dist_s[name] = time.perf_counter() - t0
            timer = StepTimer()
            timer.start()
            t0 = timer.last
            proofs = prover.prove_batch(prove_data, prove_pws, on_step=timer,
                                        mesh=mesh)
            torch.cuda.synchronize()
            mesh_prove_s = time.perf_counter() - t0
            # after the slice's last step: the proofs' plain form, the
            # object all-gather and the proofs rebuilt
            gather_s = mesh_prove_s - sum(timer.steps.values())
            launches = all_launches()
            peak = torch.cuda.max_memory_allocated() / 2**30
            log(f"parallel path launches {json.dumps(launches)}; peak device "
                f"memory {peak:.3f} GiB")

            # outside the counted run: this rank's block of each
            # single-device result, the replicated caps whole; then each
            # distributed call again (warm)
            for name, (what, _) in calls.items():
                (lde, cap), (want_lde, want_cap) = got[name], single[name]
                require_equal(lde, mesh_mod.shard(mesh, want_lde),
                              f"{name}: rank {mesh_mod.rank(mesh)}'s block "
                              f"of the {what}")
                if cap is not None:
                    require_equal(cap, want_cap, f"{name}: the cap of the "
                                  f"{what}")
                del lde, cap, want_lde, want_cap
                got[name] = single[name] = None
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dist_calls[name]()
                torch.cuda.synchronize()
                warm_s = time.perf_counter() - t0
                runs.append({"name": name, "what": what,
                             "dist_s": dist_s[name], "dist_warm_s": warm_s,
                             "single_s": single_s[name][0],
                             "single_warm_s": single_s[name][1]})
                log(f"phase parallel {name}: {dist_s[name]:.6f} s (warm "
                    f"{warm_s:.6f} s); single device "
                    f"{single_s[name][0]:.6f} s (warm "
                    f"{single_s[name][1]:.6f} s)")
            if [convert.proof_to_plain(p) for p in proofs] != prove_plain:
                raise AssertionError("prove_batch(mesh=) proofs differ from "
                                     "the unsharded batch's")
            steps = {k: round(v, 6) for k, v in timer.steps.items()}
            log(f"check prove_batch(mesh=) B={len(prove_pws)} == the prove "
                f"path's batch, field for field: {mesh_prove_s:.6f} s (the "
                f"proofs' gather {gather_s:.6f} s; steps {json.dumps(steps)}"
                f"); single device {prove_s:.6f} s")
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    line = {"world_size": world, "backend": backend, "setup_s": setup_s,
            "runs": runs,
            "prove_batch": {"batch": len(prove_pws), "dist_s": mesh_prove_s,
                            "gather_s": gather_s, "steps_s": timer.steps,
                            "single_s": prove_s},
            "peak_gib": peak, "launches": launches,
            "kernels": kernel_times}
    return line, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    if not (root / "city_rollup_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: city_rollup_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    from city_rollup_tpu_torch import _build, convert, pipeline
    from city_rollup_tpu_torch.core import cuda_ntt as cn
    from city_rollup_tpu_torch.core import cuda_poseidon as cp
    from city_rollup_tpu_torch.core import fri
    from city_rollup_tpu_torch.core import ntt as tn
    from city_rollup_tpu_torch.core.challenger import Challenger
    from city_rollup_tpu_torch.snark import (CircuitBuilder, CircuitConfig,
                                             minifier, prover, recursion,
                                             verifier)
    from city_rollup_tpu_torch.snark.circuit import generate_witness
    from city_rollup_tpu_torch.snark.debug import check_witness

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log("torch", torch.__version__, "cuda", torch.version.cuda)

    # --- build ------------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"phase build {time.perf_counter() - t0:.3f} s")
    log("registers and spills " + json.dumps(
        {name: _build.ptxas_usage(text) for name, text in logs.items()}))

    rng = np.random.default_rng(0)

    def rand(shape):
        return convert.from_u64(
            rng.integers(0, P, size=shape, dtype=np.uint64), dev)

    edge = [0, 1, P - 1, (1 << 32) - 1, 1 << 32, 1 << 63]

    def with_edges(x):
        for j, v in enumerate(edge[:x.shape[1]]):
            x[:, j] = v - (1 << 64) if v >= 1 << 63 else v
            if j < x.shape[0]:
                x[j, 64:128] = x[0, j]
        return x

    def by_rows(plain, x, *args, rows=8):
        """plain(x, *args), 8 batch rows at a time: K1 and K2 work row by
        row, and the plain versions' limb temporaries over the one-shot
        commit's 64 rows would not fit on the card beside the kernel's."""
        return torch.cat([plain(x[i:i + rows], *args)
                          for i in range(0, x.shape[0], rows)])

    # the full-width circuit (host only until its first proof): its
    # constants/sigmas width S is one of K4's leaf widths below
    t0 = time.perf_counter()
    full_b, full_paths, full = full_width_circuit(CircuitBuilder,
                                                  CircuitConfig)
    width_s = full.prover.const_sigma_values.shape[0]
    gate_rows = gate_row_counts(full)
    log(f"phase build full-width circuit {time.perf_counter() - t0:.3f} s: "
        f"log_n {full.common.log_n}, {FULL_PATHS} paths of height "
        f"{MERKLE_HEIGHT}, gate rows {json.dumps(gate_rows)}, "
        f"{sum(gate_rows.values())} of {full.common.n} rows, "
        f"{full.common.num_public_inputs} public inputs, S = {width_s}")

    # --- kernels against their plain versions ------------------------------
    # K1 and K2 at the NTT shapes of the main path: the commits' coset LDEs
    # (log_m 14; 23, batch 1 and the one-shot commit's 64, whose blocks run
    # over the batch; 25: one streamed slab; the input 2^rate_bits times
    # shorter, scaled by shift^j and padded inside K1), and FRI's final
    # coset_intt (inverse, scaled by n^-1 shift^-k inside K2): log_m 8 in
    # the single proof (batch 1) and the batch of 8, log_m 5 in the golden
    # proof; and an intt (n^-1 only)
    def check_k1k2(log_m, batch, log_in, mode, label=""):
        """K1 then K2 against their plain versions on one transform."""
        log_n2 = cn._split(log_m)
        x = with_edges(rand((batch, 1 << log_in)))
        pre = tn._coset_table(log_in, 7, dev) if mode == "coset_lde" \
            else None
        scale = None if mode == "coset_lde" else cn._table(
            "oscale", cn._out_scale, log_m,
            7 if mode == "coset_intt" else None, device=dev)
        where = f"log_m={log_m} batch={batch} {mode}{label}"
        y = cn._k1(x, log_m, log_n2, pre)
        require_equal(y, by_rows(cn._k1_plain, x, log_m, log_n2, pre),
                      f"ntt_fourstep_tw {where}")
        y = with_edges(y.reshape(-1, min(128, y.shape[1]))).reshape(y.shape)
        reverse = mode != "coset_lde"
        require_equal(cn._k2(y, log_m, log_n2, 0, reverse, scale),
                      by_rows(cn._k2_plain, y, log_m, log_n2, 0, reverse,
                              scale),
                      f"ntt_block {where}")

    t0 = time.perf_counter()
    for log_m, batch, log_in, mode in [
            (14, 3, 11, "coset_lde"),
            (FRI_LOG_N + RATE_BITS, 1, FRI_LOG_N, "coset_lde"),
            (ONE_SHOT_LOG_N + RATE_BITS, 64, ONE_SHOT_LOG_N, "coset_lde"),
            (25, 8, 22, "coset_lde"),
            (8, 1, 8, "coset_intt"),
            (8, 8, 8, "coset_intt"), (5, 1, 5, "coset_intt"),
            (14, 3, 14, "intt"),
            (12, PROVE_BATCH * 144, 12, "intt"),
            (15, PROVE_BATCH * 144, 12, "coset_lde"),
            (15, PROVE_BATCH * 2, 15, "coset_intt")]:
        check_k1k2(log_m, batch, log_in, mode)
        if log_m <= 23 and batch < 64:
            x = rand((batch, 1 << log_m))
            require_equal(tn.ntt(x, log_m),
                          tn._ntt_core(x, tn._root_table(log_m, False, dev),
                                       log_m),
                          f"four-step ntt == radix-2 log_m={log_m} "
                          f"batch={batch}")
        torch.cuda.empty_cache()
    # the tail kernel: no commit or FRI size reaches it (a block holds
    # transforms up to 2^13), so it is driven here, directly and through a
    # transform with MAX_KERNEL_LOG lowered (log_m 14 -> K1 2^5, K2
    # segments 2^5 + 4 tail stages)
    x = with_edges(rand((6, 1 << 13)))
    tt = cn._stage_table(13, dev)
    for s in (0, 12):
        require_equal(cn._tail_stage(x, s, 13, tt),
                      cn._tail_stage_plain(x, s, 13, tt),
                      f"ntt_tail_stage (6, 2^13) stage {s}")
    saved = cn.MAX_KERNEL_LOG
    cn.MAX_KERNEL_LOG = 5
    try:
        x = rand((3, 1 << 14))
        require_equal(tn.ntt(x, 14),
                      tn._ntt_core(x, tn._root_table(14, False, dev), 14),
                      "ntt with tail stages (MAX_KERNEL_LOG=5)")
    finally:
        cn.MAX_KERNEL_LOG = saved
    for n in (8, 10, 64):
        x = with_edges(rand((n, 1 << 14)))
        require_equal(cp.sponge_t(x), cp.sponge_t_plain(x),
                      f"poseidon_sponge n={n}")
    # the prove path's leaf widths, over the leaves of a PROVE_BATCH batch
    # (2^18) and of the constants/sigmas tree (2^15)
    for n, cols in [(w, PROVE_BATCH << 15) for w in PROVE_LEAF_WIDTHS] + \
            [(width_s, 1 << 15)]:
        x = with_edges(rand((n, cols)))
        require_equal(cp.sponge_t(x), cp.sponge_t_plain(x),
                      f"poseidon_sponge n={n} at {cols} leaves")
    del x
    # K4's Merkle-level entry reads the (4, 2B) children in place: against
    # the plain two_to_one of the strided slices, with edge values and at
    # the one-shot commit's leaf level, and against the sponge entry
    for x in (with_edges(rand((4, 1 << 15))),
              rand((4, 1 << (ONE_SHOT_LOG_N + RATE_BITS)))):
        got = cp.reduce_level_t(x)
        require_equal(got, cp.reduce_level_t_plain(x),
                      f"poseidon_sponge level entry {tuple(x.shape)}")
        require_equal(got, cp.two_to_one_t(x[:, 0::2], x[:, 1::2]),
                      f"level entry == sponge entry {tuple(x.shape)}")
        del got
    del x
    for k in (3, 8):
        s = with_edges(rand((12, 1 << 14)))
        c = with_edges(rand((k, 1 << 14)))
        require_equal(cp.absorb_t(s, c), cp.absorb_t_plain(s, c),
                      f"poseidon_absorb k={k}")
    # the permutation with edge values, and at FRI's grinding batch
    for s in (with_edges(rand((12, 1 << 14))), rand((12, 1 << 17))):
        require_equal(cp.permute_t(s), cp.permute_t_plain(s),
                      f"poseidon_permute {tuple(s.shape)}")
    torch.cuda.synchronize()
    log(f"phase kernel checks {time.perf_counter() - t0:.3f} s")

    # --- golden cap ----------------------------------------------------------
    golden = np.array(GOLDEN_CAP, dtype=np.uint64)
    sv = np.random.default_rng(7).integers(0, P, size=(16, 1 << 10),
                                           dtype=np.uint64)
    for fn in (pipeline.lde_commit, pipeline.lde_commit_streamed):
        cap = convert.to_u64(fn(sv, log_n=10, rate_bits=RATE_BITS,
                                cap_height=CAP_HEIGHT))
        if not np.array_equal(cap, golden):
            raise AssertionError(f"{fn.__name__} 2^10 x 16: cap differs "
                                 "from the reference's")
        log(f"check {fn.__name__} 2^10 x 16 seed 7: equals the golden cap")

    # --- golden FRI proof ----------------------------------------------------
    # its final coset_intt is log_m 5: the four-step kernels at 2^2 x 2^3
    t0 = time.perf_counter()
    golden_cw = tuple(tn.coset_lde(convert.from_u64(c, dev), 5, 3)
                      for c in golden_fri_coeffs())
    golden = fri.fri_prove(golden_cw, 8, 7,
                           fri.FriConfig(**GOLDEN_FRI_CONFIG), Challenger())
    wrong = golden_fri_differences(golden)
    if wrong:
        raise AssertionError(f"golden FRI proof: {wrong} differ from the "
                             "reference's")
    log(f"check fri_prove log_m 8 seed 7: equals GOLDEN_FRI "
        f"({time.perf_counter() - t0:.3f} s)")

    def all_launches():
        return {**cn.LAUNCHES, **cp.LAUNCHES}

    def zero_launches():
        torch.cuda.synchronize()
        for counts in (cn.LAUNCHES, cp.LAUNCHES):
            for key in counts:
                counts[key] = 0

    # --- the commit path, once, counted --------------------------------------
    c_one = rand((64, 1 << ONE_SHOT_LOG_N))
    c22 = rand((64, 1 << 22))
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    caps = {}
    before = all_launches()
    for name, fn, x in [
            (f"lde_commit 2^{ONE_SHOT_LOG_N} x 64", pipeline.lde_commit,
             c_one),
            ("lde_commit_streamed 2^22 x 64", pipeline.lde_commit_streamed,
             c22)]:
        t0 = time.perf_counter()
        caps[name] = fn(x, log_n=x.shape[1].bit_length() - 1,
                        rate_bits=RATE_BITS, cap_height=CAP_HEIGHT)
        torch.cuda.synchronize()
        log(f"phase {name} {time.perf_counter() - t0:.6f} s (first call)")
        now = all_launches()
        log(f"launches in {name}: "
            f"{json.dumps({k: now[k] - before[k] for k in now})}")
        before = now
    path_launches = {"commit": all_launches()}
    log(f"commit path launches {json.dumps(path_launches['commit'])}; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    require_launched(path_launches["commit"], COMMIT_KERNELS, "commit")
    for name, cap in caps.items():
        u = convert.to_u64(cap)
        if u.shape != (1 << CAP_HEIGHT, 4) or (u >= P).any():
            raise AssertionError(f"{name}: malformed cap {u.shape}")

    # second calls: warm times, outside the counted run
    for name, fn, x in [
            (f"lde_commit 2^{ONE_SHOT_LOG_N} x 64", pipeline.lde_commit,
             c_one),
            ("lde_commit_streamed 2^22 x 64", pipeline.lde_commit_streamed,
             c22)]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = fn(x, log_n=x.shape[1].bit_length() - 1,
                   rate_bits=RATE_BITS, cap_height=CAP_HEIGHT)
        torch.cuda.synchronize()
        log(f"phase {name} {time.perf_counter() - t0:.6f} s (warm)")
        if not torch.equal(again, caps[name]):
            raise AssertionError(f"{name}: second call differs")
    del c22
    t0 = time.perf_counter()
    streamed_one = pipeline.lde_commit_streamed(
        c_one, log_n=ONE_SHOT_LOG_N, rate_bits=RATE_BITS,
        cap_height=CAP_HEIGHT)
    torch.cuda.synchronize()
    log(f"phase lde_commit_streamed 2^{ONE_SHOT_LOG_N} x 64 "
        f"{time.perf_counter() - t0:.6f} s")
    if not torch.equal(streamed_one,
                       caps[f"lde_commit 2^{ONE_SHOT_LOG_N} x 64"]):
        raise AssertionError(f"streamed != one-shot at 2^{ONE_SHOT_LOG_N} "
                             "x 64")
    log(f"check lde_commit_streamed == lde_commit at 2^{ONE_SHOT_LOG_N} x 64")
    del c_one, caps, streamed_one, again
    torch.cuda.empty_cache()

    # --- the FRI path, once, counted -----------------------------------------
    # ext codewords: the LDEs of random coefficient pairs, made before the
    # counted run
    cfg = fri.FriConfig()
    log_n_fri, log_n_batch, batch = FRI_LOG_N, 17, 8
    cw_one = tuple(tn.coset_lde(rand((1 << log_n_fri,)), log_n_fri,
                              cfg.rate_bits) for _ in range(2))
    cw20 = tuple(tn.coset_lde(rand((batch, 1 << log_n_batch)), log_n_batch,
                              cfg.rate_bits) for _ in range(2))
    log_m_one = log_n_fri + cfg.rate_bits
    log_m20 = log_n_batch + cfg.rate_bits
    shift = 7
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    before = all_launches()
    fri_runs = [
        (f"fri_prove log_m {log_m_one}",
         lambda: fri.fri_prove(cw_one, log_m_one, shift, cfg, Challenger())),
        (f"fri_prove_batch B={batch} log_m {log_m20}",
         lambda: fri.fri_prove_batch(cw20, log_m20, shift, cfg,
                                     [Challenger() for _ in range(batch)]))]
    proofs = {}
    for name, run in fri_runs:
        t0 = time.perf_counter()
        proofs[name] = run()
        torch.cuda.synchronize()
        log(f"phase {name} {time.perf_counter() - t0:.6f} s (first call)")
        now = all_launches()
        log(f"launches in {name}: "
            f"{json.dumps({k: now[k] - before[k] for k in now})}")
        before = now
    path_launches["fri"] = all_launches()
    log(f"FRI path launches {json.dumps(path_launches['fri'])}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    require_launched(path_launches["fri"], FRI_KERNELS, "FRI")
    proof_one = proofs[fri_runs[0][0]]
    batch_proofs = proofs[fri_runs[1][0]]
    if len(proof_one.commit_caps) != cfg.num_folds(log_n_fri) or \
            len(proof_one.final_poly) != 1 << cfg.final_poly_bits or \
            len(batch_proofs) != batch:
        raise AssertionError("FRI proofs of the wrong shape")

    # outside the counted run: warm time, batch == single, host verifier
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = fri_runs[0][1]()
    torch.cuda.synchronize()
    log(f"phase {fri_runs[0][0]} {time.perf_counter() - t0:.6f} s (warm)")
    if not convert.fri_proof_equal(again, proof_one):
        raise AssertionError("fri_prove: second call differs")
    t0 = time.perf_counter()
    single = fri.fri_prove((cw20[0][0], cw20[1][0]), log_m20, shift, cfg,
                           Challenger())
    log(f"phase fri_prove log_m {log_m20} "
        f"{time.perf_counter() - t0:.6f} s")
    if not convert.fri_proof_equal(single, batch_proofs[0]):
        raise AssertionError("fri_prove_batch proof 0 != fri_prove alone")
    log(f"check fri_prove_batch proof 0 == fri_prove at log_m {log_m20}")
    for name, proof, log_m in [(f"log_m {log_m_one}", proof_one, log_m_one),
                               (f"batch proof 0 log_m {log_m20}",
                                batch_proofs[0], log_m20)]:
        t0 = time.perf_counter()
        ok = fri.fri_verify(proof, log_m, shift, cfg, Challenger())
        log(f"phase fri_verify {name} {time.perf_counter() - t0:.6f} s")
        if not ok:
            raise AssertionError(f"fri_verify rejects the {name} proof")
        log(f"check fri_verify accepts the {name} proof")
    c = proof_one.final_poly[0]
    proof_one.final_poly[0] = ((c[0] + 1) % P, c[1])
    if fri.fri_verify(proof_one, log_m_one, shift, cfg, Challenger()):
        raise AssertionError("fri_verify accepts a tampered final poly")
    log("check fri_verify rejects a changed final-poly coefficient")
    del cw_one, cw20, proofs, proof_one, batch_proofs, again, single
    torch.cuda.empty_cache()

    # --- golden snark proof ------------------------------------------------
    t0 = time.perf_counter()
    tiny_b = CircuitBuilder(fast_config(CircuitConfig, fri.FriConfig))
    x_t = tiny_circuit(tiny_b)
    tiny = tiny_b.build()
    pw = tiny_b.partial_witness()
    pw.set(x_t, 3)
    golden = prover.prove(tiny, pw)
    if proof_digest(convert.proof_to_plain(golden)) != GOLDEN_PROOF:
        raise AssertionError("golden snark proof differs from the "
                             "reference's")
    if not verifier.verify(golden, tiny.common, tiny.verifier):
        raise AssertionError("verify rejects the golden snark proof")
    log(f"check prove of the tiny circuit (log_n {tiny.common.log_n}): "
        f"equals GOLDEN_PROOF, verifies ({time.perf_counter() - t0:.3f} s)")

    # --- the prove path, once, counted -------------------------------------
    # partial witnesses (random leaves, index bits and siblings) are made
    # before the counted run; generating the wire values from them is the
    # prove's first step. Witness 0 for prove, 1..8 for prove_batch.
    def witness(seed):
        return merkle_paths_witness(full_b, full_paths, seed)

    def counted_prove(name, data, pws, runs):
        """prove_batch(data, pws), timed by step, with its peak device
        memory and its launches since the last counted run, in runs."""
        nonlocal before
        timer = StepTimer()
        torch.cuda.reset_peak_memory_stats()
        # what earlier phases left allocated (cached NTT and fold tables)
        held = torch.cuda.memory_allocated() / 2**30
        timer.start()
        t_start = timer.last
        proofs = prover.prove_batch(data, pws, on_step=timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        peak = torch.cuda.max_memory_allocated() / 2**30
        now = all_launches()
        runs.append({"name": name, "batch": len(pws),
                     "log_n": data.common.log_n, "wall_s": wall,
                     "peak_gib": peak, "held_before_gib": held,
                     "steps_s": timer.steps,
                     "launches": {k: now[k] - before[k] for k in now}})
        before = now
        log(f"phase {name} log_n {data.common.log_n} {wall:.6f} s, peak "
            f"device memory {peak:.3f} GiB ({held:.3f} GiB held before "
            f"it); steps "
            f"{json.dumps({k: round(v, 6) for k, v in timer.steps.items()})}")
        log(f"launches in {name}: {json.dumps(runs[-1]['launches'])}")
        return proofs

    zero_launches()
    before = all_launches()
    prove_runs = []
    t0 = time.perf_counter()
    full_vd = full.verifier           # the preprocessing: K1, K2, K4
    torch.cuda.synchronize()
    log(f"phase preprocess (constants/sigmas LDE + tree, S = {width_s}) "
        f"{time.perf_counter() - t0:.6f} s")
    full_proofs = {}
    for name, pws in [("prove B=1", [witness(0)]),
                      ("prove B=1 warm", [witness(0)]),
                      (f"prove_batch B={PROVE_BATCH}",
                       [witness(s) for s in range(1, PROVE_BATCH + 1)])]:
        full_proofs[name] = counted_prove(name, full, pws, prove_runs)
    path_launches["prove"] = all_launches()
    log(f"prove path launches {json.dumps(path_launches['prove'])}")
    require_launched(path_launches["prove"], PROVE_KERNELS, "prove")

    # outside the counted run: determinism, batch == single, the verifier
    one, warm = full_proofs["prove B=1"][0], full_proofs["prove B=1 warm"][0]
    batch_proofs = full_proofs[f"prove_batch B={PROVE_BATCH}"]
    if convert.proof_to_plain(one) != convert.proof_to_plain(warm):
        raise AssertionError("prove: second call differs")
    if len(batch_proofs) != PROVE_BATCH or \
            len(one.initial_openings) != fri.FriConfig().num_query_rounds:
        raise AssertionError("proofs of the wrong shape")
    t0 = time.perf_counter()
    alone = prover.prove(full, witness(1))
    log(f"phase prove B=1 of batch witness 0 "
        f"{time.perf_counter() - t0:.6f} s")
    if convert.proof_to_plain(alone) != convert.proof_to_plain(
            batch_proofs[0]):
        raise AssertionError("prove_batch proof 0 != prove alone")
    log("check prove_batch proof 0 == prove of its witness alone")
    t0 = time.perf_counter()
    results = in_forked_processes(
        lambda proof: verifier.verify(proof, full.common, full_vd),
        [one] + batch_proofs)
    verify_s = [t for _, t in results]
    for i, (ok, _) in enumerate(results):
        if not ok:
            raise AssertionError(f"verify rejects full-width proof {i}")
    log(f"check verify accepts all {len(verify_s)} full-width proofs "
        f"({', '.join(f'{t:.3f}' for t in verify_s)} s; "
        f"{time.perf_counter() - t0:.3f} s in worker processes)")
    w0 = one.openings.wires[0]
    one.openings.wires[0] = ((w0[0] + 1) % P, w0[1])
    if verifier.verify(one, full.common, full_vd):
        raise AssertionError("verify accepts a tampered opening")
    log("check verify rejects a changed wire opening")
    prove_line = {
        "log_n": full.common.log_n, "paths": FULL_PATHS,
        "height": MERKLE_HEIGHT, "gate_rows": gate_rows,
        "public_inputs": full.common.num_public_inputs,
        "runs": prove_runs, "verify_s": verify_s}
    leaf_proof = warm
    # the parallel phase's prove_batch(mesh=) is held against this batch
    batch_plain = [convert.proof_to_plain(p) for p in batch_proofs]
    batch_s = prove_runs[-1]["wall_s"]
    del full_proofs, one, batch_proofs, alone
    torch.cuda.empty_cache()

    # --- golden wrap proof ---------------------------------------------------
    # the tests' tiny recursion chain: the inner proof (log_n 3), then the
    # 2^10 wrapper that verifies it in-circuit
    t0 = time.perf_counter()
    inner_cfg, wrap_cfg = recursion_configs(CircuitConfig, fri.FriConfig)
    inner_b = CircuitBuilder(inner_cfg)
    inner_xy = recursion_inner_circuit(inner_b)
    inner = inner_b.build()
    pw = inner_b.partial_witness()
    for t, v in zip(inner_xy, RECURSION_INNER_XY):
        pw.set(t, v)
    inner_proof = prover.prove(inner, pw)
    tiny_wrap = minifier.ProofMinifier.build(inner, wrap_cfg)
    golden = tiny_wrap.prove(inner_proof)
    if proof_digest(convert.proof_to_plain(golden)) != GOLDEN_WRAP_PROOF:
        raise AssertionError("golden wrap proof differs from the "
                             "reference's")
    if not verifier.verify(golden, tiny_wrap.data.common,
                           tiny_wrap.data.verifier):
        raise AssertionError("verify rejects the golden wrap proof")
    log(f"check the tiny wrapper (log_n {tiny_wrap.data.common.log_n}) of "
        f"the inner proof (log_n {inner.common.log_n}): equals "
        f"GOLDEN_WRAP_PROOF, verifies ({time.perf_counter() - t0:.3f} s)")
    del inner, inner_proof, tiny_wrap, golden

    # --- the recursion path, once, counted ---------------------------------
    # the wrapper of the full-width leaf proof (verifier data as circuit
    # constants, the leaf's public inputs exposed again), built on the host
    t0 = time.perf_counter()
    wrap, wrap_witness = wrapper_of(full, minifier, recursion)
    wrap_build_s = time.perf_counter() - t0
    wrap_rows = gate_row_counts(wrap.data)
    width_w = wrap.data.prover.const_sigma_values.shape[0]
    log(f"phase build wrapper {wrap_build_s:.3f} s: log_n "
        f"{wrap.data.common.log_n}, gate rows {json.dumps(wrap_rows)}, "
        f"{sum(wrap_rows.values())} of {wrap.data.common.n} rows, "
        f"{wrap.data.common.num_public_inputs} public inputs, S = {width_w}")
    if wrap.data.common.log_n != 15 or \
            wrap.data.common.num_public_inputs != \
            full.common.num_public_inputs:
        raise AssertionError("wrapper of an unexpected shape")
    # the aggregation step's circuit (host) over the wrapper's shape
    t0 = time.perf_counter()
    agg_b = CircuitBuilder(CircuitConfig.poseidon_config())
    agg_pt, agg_vdt = aggregation_circuit(agg_b, recursion, wrap.data.common)
    agg = agg_b.build()
    agg_build_s = time.perf_counter() - t0
    agg_rows = gate_row_counts(agg)
    log(f"phase build aggregation step {agg_build_s:.3f} s: log_n "
        f"{agg.common.log_n}, gate rows {json.dumps(agg_rows)}, "
        f"{sum(agg_rows.values())} of {agg.common.n} rows")

    # K1/K2 and K4 at the shapes of the recursion path's proves (B = 1,
    # 2^15 rows, 2^18 LDE points): the intt and coset LDE of each committed
    # matrix (the wires, Z and partial products, the constants/sigmas of
    # the wrapper and of the aggregation step), the quotient's coset_intt
    # of (B, num_challenges) rows and the coset LDE of its chunks; the
    # leaf widths over 2^18
    width_a = agg.prover.const_sigma_values.shape[0]
    t0 = time.perf_counter()
    for rows in sorted({width_w, width_a, 144, 10}):
        check_k1k2(15, rows, 15, "intt", " (recursion)")
        check_k1k2(18, rows, 15, "coset_lde", " (recursion)")
    check_k1k2(18, 16, 15, "coset_lde", " (recursion quotient chunks)")
    for rows in (2, 16):
        check_k1k2(18, rows, 18, "coset_intt", " (recursion)")
    for n in sorted({144, width_w, width_a, 10, 16}):
        x = with_edges(rand((n, 1 << 18)))
        require_equal(cp.sponge_t(x), cp.sponge_t_plain(x),
                      f"poseidon_sponge n={n} at {1 << 18} leaves "
                      f"(recursion)")
    del x
    torch.cuda.empty_cache()
    log(f"phase recursion kernel checks {time.perf_counter() - t0:.3f} s")

    zero_launches()
    before = all_launches()
    t0 = time.perf_counter()
    wrap_vd = wrap.data.verifier      # the preprocessing: K1, K2, K4
    torch.cuda.synchronize()
    wrap_pre_s = time.perf_counter() - t0
    log(f"phase preprocess wrapper (S = {width_w}) {wrap_pre_s:.6f} s")
    # one wrap prove (a second, warm one was cut to fit the call's time;
    # the prove path checks that a second call gives the same proof)
    rec_runs = []
    wrap_proof = counted_prove("wrap prove", wrap.data,
                               [wrap_witness(leaf_proof)], rec_runs)[0]
    # the aggregation step admits the wrapper's proof by the fingerprint of
    # verifier data given as witness
    t0 = time.perf_counter()
    agg_vd = agg.verifier
    torch.cuda.synchronize()
    agg_pre_s = time.perf_counter() - t0
    agg_pw = agg_b.partial_witness()
    recursion.set_proof_witness(agg_pw, agg_pt, wrap_proof)
    recursion.set_verifier_data_witness(agg_pw, agg_vdt, wrap_vd)
    agg_proof = counted_prove("aggregation step prove", agg, [agg_pw],
                              rec_runs)[0]
    path_launches["recursion"] = all_launches()
    log(f"recursion path launches {json.dumps(path_launches['recursion'])}")
    # the recursion path proves its circuits as the prove path does
    require_launched(path_launches["recursion"], PROVE_KERNELS, "recursion")

    # outside the counted run: the host verifier, public inputs, tampering
    rec_verify_s = {}
    for name, proof, data, vd in [("wrap", wrap_proof, wrap.data, wrap_vd),
                                  ("aggregation step", agg_proof, agg,
                                   agg_vd)]:
        t0 = time.perf_counter()
        ok = verifier.verify(proof, data.common, vd)
        rec_verify_s[name] = time.perf_counter() - t0
        if not ok:
            raise AssertionError(f"verify rejects the {name} proof")
    if wrap_proof.public_inputs != leaf_proof.public_inputs:
        raise AssertionError("the wrapper's public inputs are not the "
                             "leaf's")
    fingerprint = recursion.fingerprint_verifier_data(wrap_vd)
    if agg_proof.public_inputs != fingerprint:
        raise AssertionError("the aggregation step's public inputs are not "
                             "the wrapper's fingerprint")
    log(f"check verify accepts the wrap and aggregation-step proofs "
        f"({rec_verify_s['wrap']:.3f}, "
        f"{rec_verify_s['aggregation step']:.3f} s); the wrap exposes the "
        f"leaf's {len(leaf_proof.public_inputs)} public inputs, the "
        f"aggregation step the wrapper's fingerprint")
    t0 = time.perf_counter()
    wires = generate_witness(wrap.data, wrap_witness(leaf_proof))
    pi_hash = prover.public_inputs_hash(leaf_proof.public_inputs)
    if check_witness(wrap.data, wires, pi_hash):
        raise AssertionError("check_witness rejects the wrapper's witness")
    tampered = copy.deepcopy(leaf_proof)
    w0 = tampered.openings.wires[0]
    tampered.openings.wires[0] = ((w0[0] + 1) % P, w0[1])
    try:
        generate_witness(wrap.data, wrap_witness(tampered))
        raise AssertionError("a tampered leaf proof completes into a "
                             "wrapper witness")
    except ValueError as e:
        conflict = str(e)
    forged = with_target_value(wrap.data, wires,
                               wrap.proof_targets.openings.wires[0][0],
                               tampered.openings.wires[0][0])
    violations = check_witness(wrap.data, forged, pi_hash)
    if not violations:
        raise AssertionError("check_witness accepts the wrapper witness of a "
                             "tampered leaf proof")
    log(f"check a changed leaf wire opening: no wrapper witness "
        f"({conflict[:60]}...), and check_witness reports "
        f"{len(violations)} violated constraints on the forged one, the "
        f"first {violations[0][:60]} ({time.perf_counter() - t0:.3f} s)")
    recursion_line = {
        "steps": [
            {"name": "leaf", "log_n": full.common.log_n,
             "rows": sum(gate_rows.values()), "gate_rows": gate_rows},
            {"name": "wrap", "log_n": wrap.data.common.log_n,
             "rows": sum(wrap_rows.values()), "gate_rows": wrap_rows,
             "build_s": wrap_build_s, "preprocess_s": wrap_pre_s},
            {"name": "aggregation step", "log_n": agg.common.log_n,
             "rows": sum(agg_rows.values()), "gate_rows": agg_rows,
             "build_s": agg_build_s, "preprocess_s": agg_pre_s}],
        "runs": rec_runs, "verify_s": rec_verify_s,
        "launches": path_launches["recursion"]}
    del wrap, agg, agg_b, wrap_proof, agg_proof, wires, forged
    torch.cuda.empty_cache()

    # --- the rollup's block pipeline, counted --------------------------------
    with contextlib.ExitStack() as fleet:
        (rollup_line, rollup_kernels, path_launches["rollup"],
         path_launches["sighash"]) = rollup_phase(dev, all_launches,
                                                  zero_launches, fleet)
    log(f"rollup path launches {json.dumps(path_launches['rollup'])}")
    require_launched(path_launches["rollup"], ROLLUP_KERNELS, "rollup")
    log(f"sighash path launches {json.dumps(path_launches['sighash'])}")
    require_launched(path_launches["sighash"], SIGHASH_KERNELS, "sighash")
    torch.cuda.empty_cache()

    # --- the parallel path, counted (last: nothing forks or starts a
    # process while its process group is live) --------------------------------
    parallel_line, path_launches["parallel"] = parallel_phase(
        dev, all_launches, zero_launches, full,
        [witness(s) for s in range(1, PROVE_BATCH + 1)], batch_plain,
        batch_s)
    require_launched(path_launches["parallel"], PARALLEL_KERNELS, "parallel")
    launches = {k: sum(p[k] for p in path_launches.values())
                for k in path_launches["commit"]}

    # --- per-kernel times at the main path's shapes --------------------------
    kernels = []

    def measure(name, source, replaces, shape, kernel, plain, reps,
                nbytes, ops):
        got = kernel()
        torch.cuda.synchronize()
        t = time.perf_counter()
        want = plain()
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t
        err = max_abs_err(got, want)
        if err:
            raise AssertionError(f"{name} at {shape}: max abs err {err}")
        del got, want
        ms = cuda_ms(kernel, reps)
        t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
        t_ops = ops / OPS_PER_S * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_s * 1e3,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "shape": shape,
            "launches_by_path": {p: c[name]
                                 for p, c in path_launches.items()}})
        log(f"time {name} {shape}: {ms:.4f} ms, plain {plain_s * 1e3:.1f} "
            f"ms, bound {max(t_bytes, t_ops):.4f} ms")
        torch.cuda.empty_cache()

    # the NTT kernels at one 8-poly slab of the 2^22 streamed commit:
    # coefficients (8, 2^22) -> LDE (8, 2^25), n2 = 2^12, n1 = 2^13
    log_in, log_m = 22, 22 + RATE_BITS
    log_n2 = cn._split(log_m)
    log_n1 = log_m - log_n2
    n_in, n_val = 8 << log_in, 8 << log_m
    x = rand((8, 1 << log_in))
    pre = tn._coset_table(log_in, 7, dev)
    pw2 = cn._table("pw", cn._pow_cols, log_n2, device=dev)
    tw = cn._table("tw", cn._tw_cols, log_m, device=dev)
    measure("ntt_fourstep_tw", "city_rollup_tpu_torch/csrc/ntt.cu",
            "city_rollup_tpu/core/pallas_ntt.py:183",
            [list(x.shape), [8, 1 << log_m]],
            lambda: cn._k1(x, log_m, log_n2, pre),
            lambda: cn._k1_plain(x, log_m, log_n2, pre), 5,
            8 * (n_in + n_val + pre.numel() + pw2.numel() + tw.numel()),
            (n_in + 2 * n_val + ntt_products(log_n2, n_val))
            * OPS_MULMOD)
    y = cn._k1(x, log_m, log_n2, pre)
    del x
    pw1 = cn._table("pw", cn._pow_cols, log_n1, device=dev)
    measure("ntt_block", "city_rollup_tpu_torch/csrc/ntt.cu",
            "city_rollup_tpu/core/pallas_ntt.py:176",
            [8, 1 << log_m],
            lambda: cn._k2(y, log_m, log_n2),
            lambda: cn._k2_plain(y, log_m, log_n2), 5,
            8 * (2 * n_val + pw1.numel()),
            ntt_products(log_n1, n_val) * OPS_MULMOD)
    del y
    # the tail kernel, off the main path now, at its former shape there:
    # stage 12 of (8 * 2^12) rows of 2^13
    b = rand((8 << 12, 1 << 13))
    tt = cn._stage_table(13, dev)
    measure("ntt_tail_stage", "city_rollup_tpu_torch/csrc/ntt.cu",
            "city_rollup_tpu/core/pallas_ntt.py:204",
            list(b.shape) + ["stage 12"],
            lambda: cn._tail_stage(b, 12, 13, tt),
            lambda: cn._tail_stage_plain(b, 12, 13, tt), 5,
            16 * n_val + 8 * (1 << 12), n_val // 2 * OPS_MULMOD)
    del b
    torch.cuda.empty_cache()
    # the whole coset LDE (K1 + K2) of one streamed slab and of the
    # one-shot commit, beside its byte bound (ntt_pair_bounds_ms)
    ldes = []
    for lb, ln in [(8, 22), (64, ONE_SHOT_LOG_N)]:
        c = rand((lb, 1 << ln))
        bound, fourstep = ntt_pair_bounds_ms(lb, 1 << ln,
                                             1 << (ln + RATE_BITS))
        t = cuda_ms(lambda: tn.coset_lde(c, ln, RATE_BITS), 5)
        ldes.append({"shape": [[lb, 1 << ln], [lb, 1 << (ln + RATE_BITS)]],
                     "ms": t, "bound_ms": bound, "bound_by": "bytes",
                     "fourstep_bytes_ms": fourstep})
        log(f"time coset_lde ({lb}, 2^{ln}) -> ({lb}, 2^{ln + RATE_BITS}): "
            f"{t:.4f} ms, byte bound {bound:.4f} ms (four-step "
            f"{fourstep:.4f} ms)")
        del c
        torch.cuda.empty_cache()
    # the leaf hash of the one-shot commit (64 x 2^ONE_SHOT_LOG_N)
    log_m1 = ONE_SHOT_LOG_N + RATE_BITS
    leaves = rand((64, 1 << log_m1))
    measure("poseidon_sponge", "city_rollup_tpu_torch/csrc/poseidon.cu",
            "city_rollup_tpu/core/pallas_poseidon.py:190",
            list(leaves.shape),
            lambda: cp.sponge_t(leaves), lambda: cp.sponge_t_plain(leaves), 3,
            8 * (64 + 4) << log_m1, 8 * OPS_PERMUTATION << log_m1)
    del leaves
    # K4's Merkle-level entry at the one-shot commit's leaf level (its
    # launches count under poseidon_sponge)
    level = rand((4, 1 << log_m1))
    log(f"time poseidon_sponge level entry (4, 2^{log_m1}): "
        f"{cuda_ms(lambda: cp.reduce_level_t(level), 20):.4f} ms")
    del level
    # one slab absorb at M = 2^23 (a streamed commit of 2^20 x 64: the
    # shape timed since the first slice)
    state, slab = rand((12, 1 << 23)), rand((8, 1 << 23))
    measure("poseidon_absorb", "city_rollup_tpu_torch/csrc/poseidon.cu",
            "city_rollup_tpu/core/pallas_poseidon.py:207",
            [list(state.shape), list(slab.shape)],
            lambda: cp.absorb_t(state, slab),
            lambda: cp.absorb_t_plain(state, slab), 5,
            8 * (12 + 8 + 12) << 23, OPS_PERMUTATION << 23)
    del state, slab
    # one grinding batch of FriConfig()'s 16 pow bits: 2^17 states
    states = rand((12, 1 << 17))
    measure("poseidon_permute", "city_rollup_tpu_torch/csrc/poseidon.cu",
            "city_rollup_tpu/core/pallas_poseidon.py:183",
            list(states.shape),
            lambda: cp.permute_t(states), lambda: cp.permute_t_plain(states),
            20, 8 * (12 + 12) << 17, OPS_PERMUTATION << 17)
    del states

    # K4 at the prove path's leaf widths (the PROVE_BATCH batch's leaves, the
    # constants/sigmas tree's 2^15), and K1 + K2 as its intt and coset LDE
    prove_kernels = []
    for label, n, cols in [("wires", 144, PROVE_BATCH << 15),
                           ("Z and partial products", 10,
                            PROVE_BATCH << 15),
                           ("quotient", 16, PROVE_BATCH << 15),
                           ("constants/sigmas", width_s, 1 << 15)]:
        x = rand((n, cols))
        perms = -(-n // 8)
        t_bytes = 8 * (n + 4) * cols / MEM_BYTES_PER_S * 1e3
        t_ops = perms * OPS_PERMUTATION * cols / OPS_PER_S * 1e3
        torch.cuda.synchronize()
        t = time.perf_counter()
        cp.sponge_t_plain(x)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t) * 1e3
        ms = cuda_ms(lambda: cp.sponge_t(x), 20)
        prove_kernels.append({
            "name": "poseidon_sponge", "what": f"{label} leaves",
            "shape": [n, cols], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
        log(f"time poseidon_sponge {label} leaves ({n}, {cols}): {ms:.4f} "
            f"ms, plain {plain_ms:.1f} ms, bound {max(t_bytes, t_ops):.4f} "
            f"ms")
    x = rand((PROVE_BATCH * 144, 1 << 12))
    for label, fn, n_out in [
            ("intt", lambda: tn.intt(x, 12), 1 << 12),
            ("coset_lde", lambda: tn.coset_lde(x, 12, RATE_BITS),
             1 << (12 + RATE_BITS))]:
        ms = cuda_ms(fn, 20)
        bound, fourstep = ntt_pair_bounds_ms(x.shape[0], 1 << 12, n_out)
        prove_kernels.append({
            "name": "ntt_fourstep_tw + ntt_block", "what": label,
            "shape": [list(x.shape), [x.shape[0], n_out]], "ms": ms,
            "bound_ms": bound, "bound_by": "bytes",
            "fourstep_bytes_ms": fourstep})
        log(f"time {label} {tuple(x.shape)} -> ({x.shape[0]}, {n_out}): "
            f"{ms:.4f} ms, byte bound {bound:.4f} ms (four-step "
            f"{fourstep:.4f} ms)")
    del x
    # the recursion path's own shapes (B = 1 at 2^15 rows): K4 on the
    # wrapper's constants/sigmas leaves (its wires, Z and quotient leaves
    # are the prove path's widths over the same 2^18), K1 + K2 as the
    # wrapper's intt, coset LDE and the quotient's coset_intt
    recursion_kernels = []
    x = rand((width_w, 1 << 18))
    perms = -(-width_w // 8)
    t_bytes = 8 * (width_w + 4) * (1 << 18) / MEM_BYTES_PER_S * 1e3
    t_ops = perms * OPS_PERMUTATION * (1 << 18) / OPS_PER_S * 1e3
    torch.cuda.synchronize()
    t = time.perf_counter()
    cp.sponge_t_plain(x)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    ms = cuda_ms(lambda: cp.sponge_t(x), 20)
    recursion_kernels.append({
        "name": "poseidon_sponge", "what": "wrapper constants/sigmas leaves",
        "shape": [width_w, 1 << 18], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
    log(f"time poseidon_sponge wrapper constants/sigmas leaves ({width_w}, "
        f"{1 << 18}): {ms:.4f} ms, plain {plain_ms:.1f} ms, bound "
        f"{max(t_bytes, t_ops):.4f} ms")
    x = rand((144, 1 << 15))
    q = rand((2, 1 << 18))
    for label, fn, rows, n_in, n_out in [
            ("intt", lambda: tn.intt(x, 15), 144, 1 << 15, 1 << 15),
            ("coset_lde", lambda: tn.coset_lde(x, 15, RATE_BITS), 144,
             1 << 15, 1 << 18),
            ("coset_intt", lambda: tn.coset_intt(q, 18), 2, 1 << 18,
             1 << 18)]:
        ms = cuda_ms(fn, 20)
        bound, fourstep = ntt_pair_bounds_ms(rows, n_in, n_out)
        recursion_kernels.append({
            "name": "ntt_fourstep_tw + ntt_block", "what": f"wrapper {label}",
            "shape": [[rows, n_in], [rows, n_out]], "ms": ms,
            "bound_ms": bound, "bound_by": "bytes",
            "fourstep_bytes_ms": fourstep})
        log(f"time wrapper {label} ({rows}, {n_in}) -> ({rows}, {n_out}): "
            f"{ms:.4f} ms, byte bound {bound:.4f} ms (four-step "
            f"{fourstep:.4f} ms)")
    del x, q

    missing = set(launches) - {k["name"] for k in kernels}
    if missing:
        raise AssertionError(f"no timing for {sorted(missing)}")
    log(card)
    log(json.dumps({"prove": prove_line}))
    log(json.dumps({"recursion": recursion_line}))
    log(json.dumps({"rollup": rollup_line}))
    log(json.dumps({"parallel": parallel_line}))
    log(json.dumps({"coset_lde": ldes, "prove_kernels": prove_kernels,
                    "recursion_kernels": recursion_kernels,
                    "rollup_kernels": rollup_kernels}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
