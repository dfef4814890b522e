"""The port's sighash host code (rollup/sighash_circuit.py's layouts,
sighash_toolbox.py's gadget ids, sha256_accelerator.py's commitment,
sighash_tree.py's whitelist, sighash_corpus.py's fixture) against the
reference's: the same inputs, made from a seed, give equal values. Host
only: nothing here builds a circuit."""

import random

import pytest

from city_rollup_tpu.rollup import btc as jbtc
from city_rollup_tpu.rollup import sha256_accelerator as jsa
from city_rollup_tpu.rollup import sighash_circuit as jsc
from city_rollup_tpu.rollup import sighash_corpus as jcorpus
from city_rollup_tpu.rollup import sighash_toolbox as jtoolbox
from city_rollup_tpu.rollup import sighash_tree as jtree
from city_rollup_tpu_torch.crypto.hashes import hash160, sha256, sha256d
from city_rollup_tpu_torch.rollup import btc
from city_rollup_tpu_torch.rollup import sha256_accelerator as sa
from city_rollup_tpu_torch.rollup import sighash_circuit as sc
from city_rollup_tpu_torch.rollup import sighash_corpus
from city_rollup_tpu_torch.rollup import sighash_toolbox
from city_rollup_tpu_torch.rollup import sighash_tree
from city_rollup_tpu_torch.rollup.circuits import FAST_TEST_CONFIG

CORPUS = "fixtures/sighash_corpus_dev.json"
GIDS = [(0, 0, 0, 0, 0), (0, 0, 1, 1, 0), (0, 0, 2, 1, 1), (1, 2, 0, 3, 0),
        (4, 4, 4, 4, 4)]


def make_hint(gid, seed: int, cfg=None, body: bytes = btc.DEV_SCRIPT_BODY):
    """A BlockSpendIntrospectionHint of shape `gid` over the covenant
    (cfg, body), with random txids, keys and states from `seed`, as the
    reference's tests/test_sighash.py makes one. Returns (hint, current
    state bytes, next state bytes)."""
    cfg = cfg or btc.dev_spend_cfg()
    rnd = random.Random(seed)

    def rbytes(n):
        return bytes(rnd.getrandbits(8) for _ in range(n))

    def redeem(state):
        return bytes([btc.OP_PUSHBYTES_32]) + state + body

    cur_state, next_state = rbytes(32), rbytes(32)
    cur_script, next_script = redeem(cur_state), redeem(next_state)
    # the previous block's transaction: its covenant input, the deposits
    # and withdrawals it had (the gid's last_block_* counts)
    fundings = [btc.BTCTransaction(
        version=2,
        inputs=[btc.BTCTransactionInput(
            hash=rbytes(32), index=0,
            script=rbytes(cfg.block_funding_script_size if k == 0 else
                          cfg.deposit_funding_script_size))
            for k in range(gid.last_block_num_deposits + 1)],
        outputs=[btc.BTCTransactionOutput(
            value=5_000_000, script=btc.p2sh_script(hash160(cur_script)))] +
        [btc.BTCTransactionOutput(value=40_000,
                                  script=btc.p2pkh_script(rbytes(20)))
         for _ in range(gid.last_block_num_withdrawals)],
        locktime=0)]
    for _ in range(gid.num_deposits):
        fundings.append(btc.BTCTransaction(
            version=2,
            inputs=[btc.BTCTransactionInput(
                hash=rbytes(32), index=0,
                script=rbytes(cfg.deposit_funding_script_size - 33) +
                b"\x02" + rbytes(32))],
            outputs=[btc.BTCTransactionOutput(
                value=1_000_000, script=btc.p2sh_script(rbytes(20)))],
            locktime=0))
    outputs = [btc.BTCTransactionOutput(
        value=5_900_000, script=btc.p2sh_script(hash160(next_script)))]
    for _ in range(gid.num_withdrawals):
        outputs.append(btc.BTCTransactionOutput(
            value=50_000, script=btc.p2pkh_script(rbytes(20))))
    block_tx = btc.BTCTransaction(
        version=2,
        inputs=[btc.BTCTransactionInput(hash=f.txid(), index=0, script=b"")
                for f in fundings],
        outputs=outputs, locktime=0)
    preimage = btc.sighash_preimage(block_tx, gid.current_spend_index,
                                    cur_script)
    return btc.BlockSpendIntrospectionHint(
        sighash_preimage=preimage, last_block_spend_index=0,
        block_spend_index=0, current_spend_index=gid.current_spend_index,
        funding_transactions=fundings,
        next_block_redeem_script=next_script), cur_state, next_state


@pytest.mark.parametrize("ids", GIDS)
def test_shape_layouts_equal_the_reference_and_the_bytes(ids):
    gid, jgid = btc.SigHashGadgetId(*ids), jbtc.SigHashGadgetId(*ids)
    for cfg, jcfg in ((btc.dev_spend_cfg(), jbtc.dev_spend_cfg()),
                      (btc.BlockSpendCoreConfig(),
                       jbtc.BlockSpendCoreConfig())):
        shape = sc.SigHashShape(gid=gid, cfg=cfg)
        jshape = jsc.SigHashShape(gid=jgid, cfg=jcfg)
        assert shape.preimage_layout() == jshape.preimage_layout()
        for i in range(shape.n_inputs):
            assert shape.funding_tx_layout(i) == jshape.funding_tx_layout(i)
        body = bytes(cfg.block_sighash_script_size - 33)
        assert sc._constant_bytes_map(shape, body) == \
            jsc._constant_bytes_map(jshape, body)
    # the dev layout against a serialized hint of that shape
    shape = sc.SigHashShape(gid=gid, cfg=btc.dev_spend_cfg())
    hint, cur_state, _ = make_hint(gid, seed=sum(ids))
    assert hint.gadget_id() == gid
    pre_len, pre_ins, pre_outs = shape.preimage_layout()
    pre = hint.sighash_preimage
    assert pre_len == len(pre)
    for i, (txid_off, _, _, _) in enumerate(pre_ins):
        assert pre[txid_off:txid_off + 32] == \
            hint.funding_transactions[i].txid()
    for i, ftx in enumerate(hint.funding_transactions):
        assert shape.funding_tx_layout(i)[0] == len(ftx.serialize())
    s_off = pre_ins[gid.current_spend_index][2]
    assert pre[s_off] == btc.OP_PUSHBYTES_32
    assert pre[s_off + 1:s_off + 33] == cur_state
    consts = sc._constant_bytes_map(shape, btc.DEV_SCRIPT_BODY)
    assert all(pre[off] == v for off, v in consts["preimage"].items())
    for i, ftx in enumerate(hint.funding_transactions):
        raw = ftx.serialize()
        assert all(raw[off] == v for off, v in consts["funding"][i].items())


def test_gid_from_felt_round_trips():
    ids = btc.generate_id_permutations(4, 4)
    assert len(ids) == 1875 and len({g.to_felt() for g in ids}) == 1875
    for gid in ids:
        felt = gid.to_felt()
        assert sighash_toolbox._gid_from_felt(felt) == gid
        assert sighash_toolbox._gid_from_felt(felt).to_felt() == \
            jtoolbox._gid_from_felt(felt).to_felt()


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_commitment_root_host_equals_the_reference(n):
    rnd = random.Random(n)
    pairs = []
    for k in range(n):
        msg = bytes(rnd.getrandbits(8) for _ in range(4 * (k + 3)))
        pairs.append((msg, sha256d(msg) if k % 2 else sha256(msg)))
    assert sa.commitment_root_host(pairs) == jsa.commitment_root_host(pairs)


@pytest.mark.parametrize("n", [1, 2, 7, 10, 33])
def test_whitelist_tree_equals_the_reference(n):
    rnd = random.Random(100 + n)
    fps = [tuple(rnd.getrandbits(63) for _ in range(4)) for _ in range(n)]
    tree = sighash_tree.SigHashMerkleTree.build(fps)
    jt = jtree.SigHashMerkleTree.build(fps)
    assert tree.root == jt.root and tree.levels == jt.levels
    for idx in sorted({0, n // 2, n - 1, n + 5}):
        proof, jproof = tree.prove(idx), jt.prove(idx)
        assert proof.verify()
        assert (proof.root, proof.value, proof.index, proof.siblings) == \
            (jproof.root, jproof.value, jproof.index, jproof.siblings)
    assert tree.index_of(fps[n - 1]) == n - 1


def test_whitelist_tree_proofs():
    """The reference's whitelist cases (tests/test_btc.py), on the port."""
    fps = [(i, i + 1, i + 2, i + 3) for i in range(0, 40, 4)]
    tree = sighash_tree.SigHashMerkleTree.build(fps)
    assert tree.height == sighash_tree.SIGHASH_WHITELIST_TREE_HEIGHT == 16
    for idx in (0, 3, len(fps) - 1):
        proof = tree.prove(idx)
        assert proof.verify()
        assert proof.value == fps[idx]
    # a non-member leaf proves the zero leaf, not a fingerprint
    p_empty = tree.prove(len(fps) + 5)
    assert p_empty.verify()
    assert p_empty.value == (0, 0, 0, 0)


def test_corpus_fixture_gives_the_references_whitelist_root(tmp_path):
    corpus = sighash_corpus.SigHashCorpus.load(CORPUS)
    jc = jcorpus.SigHashCorpus.load(CORPUS)
    assert corpus.whitelist_root() == jc.whitelist_root()
    assert corpus.config_key == sighash_corpus._config_key(FAST_TEST_CONFIG)
    assert corpus.spend_cfg == btc.dev_spend_cfg()
    assert corpus.script_body == btc.DEV_SCRIPT_BODY
    assert [g.key for g in corpus.gates()] == corpus.gate_keys
    assert len(corpus.fps) == 18 and corpus.log_d == 13
    # save/load round trip, and the reference reads the port's file
    out = tmp_path / "corpus.json"
    corpus.save(str(out))
    again = sighash_corpus.SigHashCorpus.load(str(out))
    assert again == corpus
    assert again.to_json() == corpus.to_json() == jc.to_json()
    assert jcorpus.SigHashCorpus.load(str(out)).whitelist_root() == \
        corpus.whitelist_root()
