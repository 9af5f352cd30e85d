"""The port's exact host path on the CPU against the JAX reference.

The host modules (``vmerrs``, ``evm/{evm,interpreter,gas,jump_table,
precompiles,bn256,blake2}``, ``evm/hostexec/bridge``,
``state/statedb``, ``processor/``, ``precompile/modules``,
``predicate``) are ported copies that run over the port's
``StateStore``.  Each test feeds both packages the same inputs and
holds the port to the reference with exact equality:

- (a) every fixture of ``tests/statetests`` through the port's StateDB
  and ``apply_message``: each subtest's post root and logs hash equal
  the fixture's (which the reference pins, tests/test_statetests.py);
- (b) 300 programs drawn with a fixed seed from
  ``tests/fuzz_opcode_diff.py``'s generator, each run through both
  EVMs on the native route (``EVM.call``, root frame on the native
  session) and the interpreted route (``EVM._execute``): status, gas
  left, return data, storage writes, logs, refund and post root equal;
- (c) every precompile on the reference tests' inputs and the published
  vectors of tests/test_independent_vectors.py (EIP-152 blake2f, a
  bn256 pairing): output, gas left and error class equal;
- (d) blocks of CREATE, CREATE2, reverts, SELFDESTRUCT (and a
  resurrection) and precompile calls from the reference's builder: the
  port's ``Processor`` gives the reference's receipts, gas, bloom and
  root block by block.
"""

import json
import os
import random
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import pytest

from coreth_tpu import rlp as rrlp
from coreth_tpu.chain import Genesis as RGenesis
from coreth_tpu.chain import GenesisAccount as RAccount
from coreth_tpu.chain import generate_chain as r_generate_chain
from coreth_tpu.crypto import keccak256 as rkeccak
from coreth_tpu.crypto import secp256k1 as rsecp
from coreth_tpu.evm import EVM as REVM
from coreth_tpu.evm import BlockContext as RBlockContext
from coreth_tpu.evm import TxContext as RTxContext
from coreth_tpu.evm import vmerrs as rvmerrs
from coreth_tpu.evm.evm import Config as RConfig
from coreth_tpu.mpt import EMPTY_ROOT
from coreth_tpu.params import TEST_CHAIN_CONFIG as RCFG
from coreth_tpu.state import Database
from coreth_tpu.state import StateDB as RStateDB
from coreth_tpu.types import DynamicFeeTx as RDynamicFeeTx
from coreth_tpu.types import sign_tx as r_sign_tx

from coreth_tpu_torch import rlp
from coreth_tpu_torch.chain import Genesis, GenesisAccount
from coreth_tpu_torch.crypto import keccak256
from coreth_tpu_torch.consensus.engine import DummyEngine
from coreth_tpu_torch.crypto.secp256k1 import priv_to_address
from coreth_tpu_torch.evm import EVM, BlockContext, Config, TxContext
from coreth_tpu_torch.evm import vmerrs
from coreth_tpu_torch.evm.bn256 import G2_GEN
from coreth_tpu_torch.mpt import derive_hasher
from coreth_tpu_torch.params import TEST_CHAIN_CONFIG as CFG
from coreth_tpu_torch.params.config import _phases
from coreth_tpu_torch.processor import GasPool, Message, Processor
from coreth_tpu_torch.processor import apply_message
from coreth_tpu_torch.state import StateDB, StateStore
from coreth_tpu_torch.types import Block, create_bloom, derive_sha

import fuzz_opcode_diff as F
from test_independent_vectors import VEC4_INPUT, VEC5_INPUT, VEC5_OUTPUT

CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "statetests")
GWEI = 10**9


# ------------------------------------------------------------ (a) corpus
def _num(v) -> int:
    if isinstance(v, str):
        return int(v, 16) if v.startswith("0x") else int(v)
    return int(v)


def _hx(v: str) -> bytes:
    return bytes.fromhex(v[2:] if v.startswith("0x") else v)


def _pre_state(pre: dict) -> StateStore:
    """MakePreState (state_test_util.go:40) on a fresh store."""
    store = StateStore()
    sdb = StateDB(store)
    for addr_hex, acct in pre.items():
        addr = _hx(addr_hex)
        sdb.add_balance(addr, _num(acct.get("balance", 0)))
        sdb.set_nonce(addr, _num(acct.get("nonce", 0)))
        if acct.get("code"):
            sdb.set_code(addr, _hx(acct["code"]))
        for k, v in (acct.get("storage") or {}).items():
            sdb.set_state(addr, _num(k).to_bytes(32, "big"),
                          _num(v).to_bytes(32, "big"))
    sdb.commit(delete_empty_objects=False)
    return store


def _run_subtest(fixture: dict, post: dict) -> tuple:
    """One subtest as coreth_tpu/tests_harness.py _run_one runs it, on
    the port: (post root, logs hash), or None when the tx was invalid."""
    env, txspec, idx = fixture["env"], fixture["transaction"], \
        post["indexes"]
    sdb = StateDB(_pre_state(fixture["pre"]))
    data = _hx(txspec["data"][idx["data"]])
    to = _hx(txspec["to"]) if txspec.get("to") else None
    sender = priv_to_address(int.from_bytes(_hx(txspec["secretKey"]),
                                            "big"))
    base_fee = _num(env.get("currentBaseFee", 0)) or None
    if "gasPrice" in txspec:
        gas_price = fee_cap = tip_cap = _num(txspec["gasPrice"])
    else:
        fee_cap = _num(txspec.get("maxFeePerGas", 0))
        tip_cap = _num(txspec.get("maxPriorityFeePerGas", 0))
        gas_price = min(fee_cap, (base_fee or 0) + tip_cap)
    access_list = []
    als = txspec.get("accessLists")
    if als and idx["data"] < len(als) and als[idx["data"]]:
        access_list = [(_hx(e["address"]),
                        [_hx(k) for k in e.get("storageKeys", [])])
                       for e in als[idx["data"]]]
    ctx = BlockContext(
        coinbase=_hx(env["currentCoinbase"]),
        gas_limit=_num(env.get("currentGasLimit", 10_000_000)),
        number=_num(env.get("currentNumber", 1)),
        time=_num(env.get("currentTimestamp", 1)), base_fee=base_fee)
    msg = Message(from_=sender, to=to, nonce=_num(txspec.get("nonce", 0)),
                  value=_num(txspec["value"][idx["value"]]),
                  gas_limit=_num(txspec["gasLimit"][idx["gas"]]),
                  gas_price=gas_price, gas_fee_cap=fee_cap,
                  gas_tip_cap=tip_cap, data=data, access_list=access_list)
    evm = EVM(ctx, TxContext(origin=sender, gas_price=gas_price), sdb, CFG)
    sdb.set_tx_context(b"\x00" * 32, 0)
    try:
        apply_message(evm, msg, GasPool(ctx.gas_limit))
    except Exception:  # noqa: BLE001 — a consensus-invalid tx
        return None
    logs = sdb.tx_logs()
    sdb.finalise(True)
    return (sdb.intermediate_root(True),
            keccak256(rlp.encode([lg.rlp_items() for lg in logs])))


def _fixture_files():
    return sorted(f for f in os.listdir(CORPUS) if f.endswith(".json"))


@pytest.mark.parametrize("fixture_file", _fixture_files())
def test_state_fixture_through_port(fixture_file):
    with open(os.path.join(CORPUS, fixture_file)) as fh:
        fixtures = json.load(fh)
    n = 0
    for name, fixture in fixtures.items():
        for fork, posts in fixture["post"].items():
            if fork not in ("Coreth", "Durango"):
                continue
            for post in posts:
                got = _run_subtest(fixture, post)
                n += 1
                if post.get("expectException"):
                    assert got is None, name
                    continue
                assert got == (_hx(post["hash"]), _hx(post["logs"])), name
    assert n, f"no runnable subtests in {fixture_file}"


# -------------------------------------------------------------- (b) fuzz
PORT_CFGS = {"ap2": _phases(2), "ap3": _phases(3), "durango": _phases(11),
             "cancun": _phases(11, cancun_time=0)}
REF = dict(EVM=REVM, BlockContext=RBlockContext, TxContext=RTxContext,
           Config=RConfig, vmerrs=rvmerrs, cfgs=F.CFGS)
PORT = dict(EVM=EVM, BlockContext=BlockContext, TxContext=TxContext,
            Config=Config, vmerrs=vmerrs, cfgs=PORT_CFGS)


def _fuzz_state(pkg, code: bytes):
    """The fuzzer's pre-state (the contract, slot 1 = 5, a funded
    sender), committed; returns a StateDB opened on it."""
    if pkg is REF:
        db = Database()
        sdb = RStateDB(EMPTY_ROOT, db)
    else:
        store = StateStore()
        sdb = StateDB(store)
    sdb.set_code(F.CONTRACT, code)
    for k, v in F.STORAGE.items():
        sdb.set_state(F.CONTRACT, k, v.to_bytes(32, "big"))
    sdb.add_balance(F.SENDER, 10**18)
    root = sdb.commit(False)
    return RStateDB(root, db) if pkg is REF else StateDB(store)


def _fuzz_run(pkg, fork: str, code: bytes, native: bool) -> tuple:
    cfg = pkg["cfgs"][fork]
    rules = cfg.rules(F.NUMBER, F.TIME)
    sdb = _fuzz_state(pkg, code)
    evm = pkg["EVM"](
        pkg["BlockContext"](coinbase=F.COINBASE, number=F.NUMBER,
                            time=F.TIME, gas_limit=F.ENV.gas_limit,
                            base_fee=F.BASE_FEE),
        pkg["TxContext"](origin=F.SENDER, gas_price=F.GAS_PRICE), sdb, cfg,
        pkg["Config"]())
    sdb.prepare(rules, F.SENDER, F.COINBASE, F.CONTRACT,
                list(rules.active_precompiles), [])
    if native:
        ret, gas_left, err = evm.call(F.SENDER, F.CONTRACT, F.CALLDATA,
                                      F.GAS, 0)
    else:
        ret, gas_left, err = evm._execute(
            None, F.SENDER, F.CONTRACT, F.CONTRACT, F.CALLDATA, F.GAS, 0,
            False, sdb.snapshot())
    err_kind = None if err is None else type(err).__name__
    obj = sdb._objects.get(F.CONTRACT)
    writes = sorted(obj.dirty_storage.items()) if obj is not None else []
    logs = [(bytes(lg.address), [bytes(t) for t in lg.topics],
             bytes(lg.data)) for lg in sdb.logs]
    refund = sdb.refund
    sdb.finalise(True)
    return (err_kind, gas_left, bytes(ret), writes, logs, refund,
            sdb.intermediate_root(True))


def _fuzz_programs(n: int = 300, seed: int = 0x5EED):
    """``n`` programs of the generator's full corpora, drawn with a
    fixed seed across the four forks."""
    pool = [(fork, c) for fork in F.TABLES
            for c in F.build_corpus(fork, heavy=True)]
    return random.Random(seed).sample(pool, n)


def test_random_programs_match_reference_on_both_routes():
    programs = _fuzz_programs()
    assert len({c.op for _f, c in programs}) > 100
    for fork, case in programs:
        for native in (True, False):
            want = _fuzz_run(REF, fork, case.code, native)
            got = _fuzz_run(PORT, fork, case.code, native)
            assert got == want, (fork, case.label, native)


# -------------------------------------------------------- (c) precompiles
CALLER = b"\xCA" * 20


def _pc_call(pkg, addr: bytes, data: bytes, gas: int) -> tuple:
    """One call into a precompile from a funded caller (tests/test_evm.py
    make_evm's environment)."""
    if pkg is REF:
        sdb = RStateDB(EMPTY_ROOT, Database())
        cfg = RCFG
    else:
        sdb = StateDB(StateStore())
        cfg = CFG
    evm = pkg["EVM"](pkg["BlockContext"](number=1, time=1,
                                         gas_limit=10_000_000,
                                         base_fee=25 * GWEI),
                     pkg["TxContext"](origin=CALLER, gas_price=25 * GWEI),
                     sdb, cfg)
    sdb.add_balance(CALLER, 10**24)
    sdb.finalise(False)
    sdb.prepare(evm.rules, CALLER, b"\x00" * 20, None,
                evm.active_precompile_addresses(), [])
    ret, gas_left, err = evm.call(CALLER, addr, data, gas, 0)
    return bytes(ret), gas_left, None if err is None else type(err).__name__


def _w(v: int) -> bytes:
    return v.to_bytes(32, "big")


def _modexp(base: bytes, exp: bytes, mod: bytes) -> bytes:
    return _w(len(base)) + _w(len(exp)) + _w(len(mod)) + base + exp + mod


def _ecrecover_input() -> bytes:
    h = rkeccak(b"message")
    r, s, recid = rsecp.sign(h, 0x1234)
    return h + _w(27 + recid) + _w(r) + _w(s)


G1 = _w(1) + _w(2)
G2 = (_w(G2_GEN[0].coeffs[1]) + _w(G2_GEN[0].coeffs[0])
      + _w(G2_GEN[1].coeffs[1]) + _w(G2_GEN[1].coeffs[0]))

PRECOMPILE_CASES = [
    (1, _ecrecover_input(), 10_000),
    (1, _ecrecover_input()[:64] + _w(29) + _ecrecover_input()[96:], 10_000),
    (2, b"abc", 100),
    (2, bytes(range(200)), 1_000),
    (3, b"abc", 1_000),
    (3, b"abc", 100),                      # out of gas
    (4, bytes(range(33)), 100),
    (5, _modexp(b"\x03", b"\x02", b"\x05"), 1_000),
    (5, _modexp(_w(3), _w(1 << 255), _w(2**256 - 2**32 - 977)), 10_000),
    (5, _modexp(b"", b"", b""), 1_000),
    (6, G1 + G1, 1_000),
    (6, G1 + _w(1) + _w(3), 1_000),        # not on the curve
    (7, G1 + _w(2), 10_000),
    (8, b"", 50_000),
    (8, G1 + G2, 100_000),                 # one pair: e(G1, G2) != 1
    (8, b"\x00" * 191, 100_000),           # malformed length
    (9, VEC5_INPUT, 1_000),
    (9, VEC4_INPUT, 1_000),
    (9, VEC5_INPUT[:-1], 1_000),           # bad length
]


@pytest.mark.parametrize(
    "addr,data,gas", PRECOMPILE_CASES,
    ids=[f"0x{a:02x}-{i}" for i, (a, _d, _g) in enumerate(PRECOMPILE_CASES)])
def test_precompile_matches_reference(addr, data, gas):
    target = addr.to_bytes(20, "big")
    assert _pc_call(PORT, target, data, gas) == \
        _pc_call(REF, target, data, gas)


def test_precompile_published_vectors():
    """EIP-152 vector 5 and the EIP-197 empty pairing through the port."""
    ret, gas_left, err = _pc_call(PORT, (9).to_bytes(20, "big"),
                                  VEC5_INPUT, 1_000)
    assert (ret, gas_left, err) == (VEC5_OUTPUT, 1_000 - 12, None)
    ret, gas_left, err = _pc_call(PORT, (8).to_bytes(20, "big"), b"",
                                  50_000)
    assert (int.from_bytes(ret, "big"), gas_left, err) == \
        (1, 50_000 - 45_000, None)


def test_predicate_results_decode_matches_reference():
    """The Durango header's predicate results, as the Processor reads
    them: the bytes after the fee window, decoded as the reference does
    (an empty set, as the port's chains carry, and a filled one)."""
    from coreth_tpu.predicate import PredicateResults as RResults
    from coreth_tpu.predicate import results_bytes_from_extra as r_extra
    from coreth_tpu_torch.predicate import (
        PredicateResults, results_bytes_from_extra,
    )
    filled = RResults()
    filled.set_result(3, b"\x01" * 20, b"\x05")
    filled.set_result(0, b"\x02" * 20, b"")
    filled.set_result(3, b"\x00" * 20, b"\xff\x01")
    for results in (RResults(), filled):
        extra = b"\x07" * 80 + results.encode()
        raw = results_bytes_from_extra(extra)
        assert raw == r_extra(extra)
        assert PredicateResults.decode(raw).results == \
            RResults.decode(raw).results
    assert results_bytes_from_extra(b"\x07" * 80) is None
    with pytest.raises(ValueError):
        PredicateResults.decode(filled.encode()[:-1])


# ------------------------------------------------------ (d) Processor
KEYS = [0x3100 + i for i in range(4)]
ADDRS = [priv_to_address(k) for k in KEYS]
FACTORY = b"\x61" * 20
PRECALL = b"\x62" * 20
REVERTER = b"\x63" * 20
KILLER = b"\x64" * 20

# child init code: returns the runtime CALLER SELFDESTRUCT
CHILD_INIT = bytes.fromhex("6133ff6000526002601ef3")
# FACTORY: CREATE2 the child (salt = calldata word 0) into slot 0, CALL
# it (it self-destructs to the factory), the call's flag into slot 1,
# then CREATE another child into slot 2
FACTORY_CODE = (b"\x6a" + CHILD_INIT + bytes.fromhex(
    "600052"                    # MSTORE the init code at mem[21:32]
    "600035600b60156000f5"      # CREATE2(0, 21, 11, salt)
    "8060005560006000600060006000855af1600155"
    "600b60156000f0600255"      # CREATE(0, 21, 11) -> slot 2
    "00"))
# PRECALL: copy calldata, STATICCALL ecrecover / sha256 / identity on it,
# each output word into slots 0, 1, 2
PRECALL_CODE = bytes.fromhex("366000600037") + b"".join(
    bytes.fromhex("602061010036600060") + bytes([pc])
    + bytes.fromhex("5afa5061010051") + bytes([0x60, slot, 0x55])
    for slot, pc in enumerate((1, 2, 4))) + b"\x00"
REVERTER_CODE = bytes.fromhex("600760005560006000fd")
KILLER_CODE = bytes.fromhex("33ff")
# CREATE-tx init: SSTORE slot 5 = 42 in the constructor, then return the
# runtime "store calldata word 0 at slot 0"
DEPLOY_INIT = bytes.fromhex("602a600555" "66" "60003560005500"
                            "60005260076019f3")


def _alloc(acct):
    alloc = {a: acct(balance=10**24) for a in ADDRS}
    alloc[FACTORY] = acct(balance=0, nonce=1, code=FACTORY_CODE)
    alloc[PRECALL] = acct(balance=0, nonce=1, code=PRECALL_CODE)
    alloc[REVERTER] = acct(balance=0, nonce=1, code=REVERTER_CODE)
    alloc[KILLER] = acct(balance=5, nonce=1, code=KILLER_CODE,
                         storage={_w(1): _w(9)})
    return alloc


def host_blocks():
    """(key, to, data, value) rows of each block: CREATE, CREATE2 with
    an immediate SELFDESTRUCT (and its resurrection by the same salt a
    block later), a revert, precompile calls (from a contract and
    straight from an EOA), the destruction of a genesis contract with
    storage and a transfer to it afterwards, and a transfer block."""
    deployed = rkeccak(rrlp.encode([ADDRS[0], rrlp.encode_uint(0)]))[12:]
    salt = _w(1)
    return [
        [(0, None, DEPLOY_INIT, 0), (1, b"\x45" * 20, b"", 7),
         (2, REVERTER, b"", 0)],
        [(0, FACTORY, salt, 0), (1, deployed, _w(77), 0),
         (2, PRECALL, _ecrecover_input(), 0),
         (3, (6).to_bytes(20, "big"), G1 + G1, 0),
         (3, (9).to_bytes(20, "big"), VEC5_INPUT, 0)],
        [(0, FACTORY, salt, 3), (1, KILLER, b"", 0),
         (2, (5).to_bytes(20, "big"),
          _modexp(b"\x03", b"\x02", b"\x05"), 0),
         (3, KILLER, b"", 11)],
        [(k, b"\x46" * 20, b"", 100 + k) for k in range(4)],
    ]


def host_chain(rows_of=host_blocks):
    """The reference's chain of ``rows_of()`` over the host genesis;
    returns (reference genesis, port genesis, blocks, receipts)."""
    rows = rows_of()
    rgen = RGenesis(config=RCFG, gas_limit=8_000_000, alloc=_alloc(RAccount))
    db = Database()
    rgb = rgen.to_block(db)
    nonces = [0] * len(KEYS)

    def gen(i, bg):
        for k, to, data, value in rows[i]:
            bg.add_tx(r_sign_tx(RDynamicFeeTx(
                chain_id_=RCFG.chain_id, nonce=nonces[k],
                gas_tip_cap_=GWEI, gas_fee_cap_=300 * GWEI,
                gas=1_000_000, to=to, value=value, data=data),
                KEYS[k], RCFG.chain_id))
            nonces[k] += 1

    blocks, receipts = r_generate_chain(RCFG, rgb, db, len(rows), gen,
                                        gap=2)
    pgen = Genesis(config=CFG, gas_limit=8_000_000,
                   alloc=_alloc(GenesisAccount))
    assert pgen.to_block(StateStore()).hash() == rgb.hash()
    return rgen, pgen, blocks, receipts


def test_processor_blocks_match_reference():
    _rgen, pgen, rblocks, rreceipts = host_chain()
    store = StateStore()
    parent = pgen.to_block(store).header
    proc = Processor(CFG, engine=DummyEngine())
    statuses = []
    for rb, want in zip(rblocks, rreceipts):
        block = Block.decode(rb.encode())
        sdb = StateDB(store)
        receipts, _logs, used = proc.process(block, parent, sdb)
        assert used == block.header.gas_used
        assert [r.encode_consensus() for r in receipts] == \
            [r.encode_consensus() for r in want]
        assert [r.gas_used for r in receipts] == [r.gas_used for r in want]
        assert derive_sha(receipts, derive_hasher()) == \
            block.header.receipt_hash
        assert create_bloom(receipts) == block.header.bloom
        assert [r.contract_address for r in receipts] == \
            [r.contract_address for r in want]
        assert sdb.commit(True) == block.header.root == store.trie.hash()
        statuses.extend(r.status for r in receipts)
        parent = block.header
    # the chain really holds a revert and successes of every kind
    assert 0 in statuses and statuses.count(1) >= 12
