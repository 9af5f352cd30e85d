"""K7 (per-contract traced specialisation): the port against the JAX
reference, on the CPU.

Mirrors tests/test_specialize.py, one layer at a time:

- eligibility: ``trace_eligible`` (verdict and reason) and
  ``spec_requests`` (the kdig requests, in slot order) equal the
  reference's over a corpus of contracts;
- exec: the plain straight-line program (``build_spec_exec``) equals
  the reference's on lane batches that reach every leaf kind — STOP,
  REVERT, OOG at a lumped flush, HOST on a full storage cache and on
  the stack cap, ERR on an undefined opcode and a bad jump — with kdig
  digests, device keccaks, logs and the whole ALU;
- window: K6's plain version with ``prog_id``/``kdig`` and the plain
  programs equals the reference's window program built with the same
  program set (``spec=``), on every WINDOW_CASES window and a window
  mixing traced and generic lanes;
- end to end: the chains of test_specialize.py's A/B tests replay
  through the port (``specialize=True``) and the reference
  (``CORETH_SPECIALIZE=1``; ``CORETH_NO_TOKEN_FASTPATH=1`` and
  ``CORETH_SERIAL_SHORTCIRCUIT=0``, with the port's ``token_fastpath=
  False``: the machine takes every token call) with
  equal fold roots and counters, and the port's ``specialize=False``
  run lands the same roots.

Every compared value is an integer: tolerance 0.  Inputs are made with
numpy from fixed seeds.

The generated CUDA (``specialize.cuda_source``) cannot run here, but its
device code is plain C++: g++ checks the translation unit of K6 with
the programs of the token, the pool and the keccak fan, and a host build
of it (``tests/occ_host_build.py``: CUDA spellings shimmed as plain C++,
each CTA of the window's cluster a host thread) runs windows through
``machine.occ_launch_args`` and must equal the plain version.
tests/test_torch_cuda.py runs the same on the card.
"""

import ctypes
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coreth_tpu.evm.device import adapter as radapter
from coreth_tpu.evm.device import machine as jM
from coreth_tpu.evm.device import specialize as jSP
from coreth_tpu.evm.device import tables as jtables

from coreth_tpu_torch import kernels
from coreth_tpu_torch.evm.device import adapter as A
from coreth_tpu_torch.evm.device import machine as tM
from coreth_tpu_torch.evm.device import specialize as SP
from coreth_tpu_torch.params import TEST_CHAIN_CONFIG as CFG
from coreth_tpu_torch.replay import ReplayEngine
from coreth_tpu_torch.state import StateStore
from coreth_tpu_torch.types import Block

import chip_smoke
import occ_host_build as H
import torch_machine_cases as C
from torch_machine_cases import lane, push
from test_torch_machine_replay import ADDRS, POOL, TOKEN, _chains
from test_torch_occ_replay import _record_flushes, _ref_replay

_ALL_FEATURES = frozenset(jtables.FEATURE_OPS.values())


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs():
    """The reference's window programs here are large; free what JAX
    compiled for them before the worker moves on to the next file."""
    yield
    jax.clear_caches()


# ------------------------------------------------------------ contracts
def _asm(*items) -> bytes:
    """Hex strings and ("label", name) / ("to", name) items: a label
    marks a JUMPDEST, "to" pushes its offset (PUSH2)."""
    pos, out = {}, 0
    for it in items:
        if isinstance(it, tuple):
            if it[0] == "label":
                pos[it[1]] = out
                out += 1
            else:
                out += 3
        else:
            out += len(it) // 2
    code = ""
    for it in items:
        if isinstance(it, tuple):
            code += "5b" if it[0] == "label" else \
                "61" + pos[it[1]].to_bytes(2, "big").hex()
        else:
            code += it
    return bytes.fromhex(code)


def _cd(w: int) -> str:
    """CALLDATALOAD of word ``w`` (no selector)."""
    return push(32 * w) + "35"


_BINOPS = ("01", "02", "03", "04", "05", "06", "07", "0b", "10", "11",
           "12", "13", "14", "16", "17", "18", "1a", "1b", "1c", "1d")


def _alu_code() -> bytes:
    """Every traced ALU op on calldata words (no constant folds):
    op(a = word 0, b = word 1) stored at slot k, then ADDMOD / MULMOD
    (c = word 2), EXP with a constant exponent, ISZERO and NOT."""
    code, k = "", 0
    for op in _BINOPS:
        code += _cd(1) + _cd(0) + op + push(k) + "55"
        k += 1
    for op in ("08", "09"):
        code += _cd(2) + _cd(1) + _cd(0) + op + push(k) + "55"
        k += 1
    code += push(5) + _cd(0) + "0a" + push(k) + "55"
    code += _cd(0) + "15" + push(k + 1) + "55"
    code += _cd(0) + "19" + push(k + 2) + "55"
    return bytes.fromhex(code + "00")


_MEM_LOG_CODE = bytes.fromhex(
    _cd(0) + push(0) + "52" + _cd(1) + push(32) + "52"
    + push(0) + "51" + push(32) + "51" + "01" + push(0) + "55"
    + "33" + _cd(0) + push(64) + push(0) + "a2"          # LOG2, words
    + push(40) + push(5) + "a0"                           # LOG0, unaligned
    + push(7) + push(96) + "52" + push(32) + push(96) + "a0"  # const data
    + push(40) + push(5) + "20" + push(4) + "55"          # device keccak
    + push(0x1234) + push(128) + "52" + push(32) + push(128) + "20"
    + push(5) + "55"                                      # folded keccak
    + push(0) + push(0) + "20" + push(6) + "55"           # empty keccak
    + "59" + push(1) + "55" + "58" + push(2) + "55" + "5a" + push(3) + "55"
    + push(64) + push(0) + "f3")

# x == 0: REVERT; x odd: a JUMPI to a non-JUMPDEST (ERR on the taken
# side); else a nested branch on word 1 and STOP
_BRANCH_CODE = _asm(
    _cd(0), "80", "15", ("to", "zero"), "57",
    "80", push(1), "16", push(2), "57",
    _cd(1), ("to", "one"), "57",
    push(7), push(0), "55", "00",
    ("label", "one"), push(8), push(0), "55", "00",
    ("label", "zero"), push(1), push(1), "55", push(0), push(0), "fd")

# budget blow-ups: an unbounded loop, and five data-dependent branches
# in a row (32 leaves > MAX_LEAVES)
_LOOP_CODE = bytes.fromhex("5b" + push(0) + "56")
_BRANCHY_CODE = _asm(*[x for k in range(5) for x in (
    _cd(k), ("to", f"l{k}"), "57", ("label", f"l{k}"))], "00")

_CONTEXT_CODE = C.CASES["context"][0]["code"]
_UNDEFINED_AP2 = bytes.fromhex(push(5) + push(0) + "55" + "48" + "00")

CORPUS = {
    "token": C.TOKEN_RUNTIME, "pool": C.POOL_RUNTIME,
    "jumper": chip_smoke.JUMPER_CODE,
    "mstore8": bytes.fromhex("600060005300"),
    "escaper": C.ESCAPER_CODE, "keccak_fan": chip_smoke.KECCAK_FAN_CODE,
    "slot_fan": chip_smoke.SLOT_FAN_CODE, "loop": _LOOP_CODE,
    "branchy": _BRANCHY_CODE, "alu": _alu_code(), "mem_log": _MEM_LOG_CODE,
    "branch": _BRANCH_CODE, "undefined_ap2": _UNDEFINED_AP2,
    "stack_cap": bytes.fromhex(push(1) * 65 + "00"),
}
for _name, _blocks in C.WINDOW_CASES.items():
    for _b, _lanes in enumerate(_blocks):
        for _i, _ln in enumerate(_lanes):
            CORPUS.setdefault(f"window_{_name}_{_b}_{_i}", _ln["code"])
for _name, _lanes in C.CASES.items():
    for _i, _ln in enumerate(_lanes):
        CORPUS.setdefault(f"machine_{_name}_{_i}", _ln["code"])


# ------------------------------------------------------------ eligibility
def test_constants_match_reference():
    assert SP.SPEC_OPCODES == jSP.SPEC_OPCODES
    assert SP.HOST_CTX == jSP.HOST_CTX
    assert SP.KDIG_CAP == jSP.KDIG_CAP
    assert A.SPEC_SET_CAP == radapter.SPEC_SET_CAP
    for k in ("MAX_PATH_STEPS", "MAX_TOTAL_STEPS", "MAX_LEAVES",
              "_STACK_CAP", "_MEM_CAP", "_LOG_CAP", "_LOG_DATA_CAP",
              "_KECCAK_CAP"):
        assert getattr(SP, k) == getattr(jSP, k), k
    rng = np.random.default_rng(41)
    for _ in range(300):
        op = int(rng.choice([1, 2, 3, 4, 6, 0x10, 0x11, 0x14, 0x16, 0x17,
                             0x18, 0x1A, 0x1B, 0x1C, 0x0B]))
        a = int(rng.integers(0, 300)) if rng.random() < 0.5 \
            else int.from_bytes(rng.bytes(32), "big")
        b = int.from_bytes(rng.bytes(32), "big") >> int(rng.integers(0, 256))
        assert SP._fold2(op, a, b) == jSP._fold2(op, a, b)


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_trace_eligible_matches_reference(name):
    code = CORPUS[name]
    for fork in ("durango", "ap2"):
        assert SP.trace_eligible(code, fork) == \
            jSP.trace_eligible(code, fork), fork
        assert SP.spec_requests(code, fork) == \
            jSP.spec_requests(code, fork), fork


def test_eligibility_verdicts():
    """The reference test's verdicts, and the budgets' reasons."""
    assert SP.trace_eligible(C.TOKEN_RUNTIME, "durango") == (True, "")
    assert SP.trace_eligible(C.POOL_RUNTIME, "durango") == (True, "")
    ok, reason = SP.trace_eligible(chip_smoke.JUMPER_CODE, "durango")
    assert not ok and "jump" in reason
    ok, reason = SP.trace_eligible(CORPUS["mstore8"], "durango")
    assert not ok and "0x53" in reason
    assert SP.trace_eligible(_LOOP_CODE, "durango") == \
        (False, "step budget exceeded")
    assert SP.trace_eligible(_BRANCHY_CODE, "durango") == \
        (False, "leaf budget exceeded")
    reqs = SP.spec_requests(chip_smoke.KECCAK_FAN_CODE, "durango")
    assert len(reqs) == SP.KDIG_CAP
    assert len(SP.spec_requests(C.TOKEN_RUNTIME, "durango")) == 2
    with pytest.raises(SP.TraceIneligible):
        SP.build_spec_exec(SP.SpecProgram(chip_smoke.JUMPER_CODE,
                                          "durango"), None)


# ------------------------------------------------------------------ exec
def _words(rng, n):
    """n calldata words mixing edge values and random ones."""
    edges = [0, 1, 2, 3, 31, 255, 256, 2**255, 2**256 - 1, 2**256 - 6,
             2**128 - 1]
    return [edges[int(rng.integers(len(edges)))] if rng.random() < 0.5
            else int.from_bytes(rng.bytes(32), "big")
            >> int(rng.integers(0, 256)) for _ in range(n)]


def _data(words) -> bytes:
    return b"".join(w.to_bytes(32, "big") for w in words)


def _erc20_lanes():
    bal = C.balance_slot(C.SENDER)
    to = C.balance_slot(b"\x22" * 20)
    full = {bal: 10**18, to: 5}
    xfer = C.transfer_calldata(b"\x22" * 20, 1234)
    return [
        lane(C.TOKEN_RUNTIME, xfer, gas=200_000, storage=full),
        lane(C.TOKEN_RUNTIME, xfer, gas=200_000, storage={bal: 10, to: 5}),
        lane(C.TOKEN_RUNTIME, xfer, gas=40, storage=full),       # flush OOG
        lane(C.TOKEN_RUNTIME, xfer, gas=30_000, storage=full),   # SSTORE OOG
        lane(C.TOKEN_RUNTIME, xfer, gas=200_000, storage={bal: 10**18}),
        lane(C.TOKEN_RUNTIME, C.BALANCEOF_SELECTOR + b"\x00" * 12
             + C.SENDER, gas=100_000, storage={bal: 77}),
        lane(C.TOKEN_RUNTIME, b"\xde\xad\xbe\xef", gas=100_000),
    ]


def _pool_lanes():
    res = {C._k(0): 10**15, C._k(1): 10**15}
    return [lane(C.POOL_RUNTIME, C.swap_calldata(a), gas=g, storage=res)
            for a, g in ((1000, 200_000), (10**9, 200_000), (5, 30_000),
                         (77, 2_400))] + [
        lane(C.POOL_RUNTIME, b"\x01\x02\x03\x04", gas=50_000)]


def _calldata_lanes(code, rng, n, words=3, gas=2_000_000):
    return [lane(code, _data(_words(rng, words)), gas=gas,
                 value=int(rng.integers(0, 10**6)),
                 caller=bytes(rng.bytes(20))) for _ in range(n)]


def _exec_batches():
    rng = np.random.default_rng(7)
    alu = _alu_code()
    small = [lane(alu, _data([int(rng.integers(0, 40)),
                              int.from_bytes(rng.bytes(32), "big"),
                              int(rng.integers(1, 1000))]), gas=2_000_000)
             for _ in range(3)]
    return {
        "erc20": (C.TOKEN_RUNTIME, "durango", _erc20_lanes(), 16),
        "pool": (C.POOL_RUNTIME, "durango", _pool_lanes(), 16),
        "alu": (alu, "durango", _calldata_lanes(alu, rng, 5) + small, 32),
        "mem_log": (_MEM_LOG_CODE, "durango",
                    _calldata_lanes(_MEM_LOG_CODE, rng, 6, 2)
                    + [lane(_MEM_LOG_CODE, b"\x05" * 64, gas=900)], 16),
        "branch": (_BRANCH_CODE, "durango",
                   [lane(_BRANCH_CODE, _data([x, y]), gas=g)
                    for x, y, g in ((0, 0, 60_000), (3, 0, 60_000),
                                    (4, 0, 60_000), (4, 9, 60_000),
                                    (6, 1, 50))], 16),
        "keccak_fan": (chip_smoke.KECCAK_FAN_CODE, "durango",
                       _calldata_lanes(chip_smoke.KECCAK_FAN_CODE, rng, 4, 1,
                                       gas=200_000)
                       + [lane(chip_smoke.KECCAK_FAN_CODE, b"\x01" * 32,
                               gas=24_000)], 16),
        "slot_fan": (chip_smoke.SLOT_FAN_CODE, "durango",
                     _calldata_lanes(chip_smoke.SLOT_FAN_CODE, rng, 2, 1)
                     + [lane(chip_smoke.SLOT_FAN_CODE, b"\x00" * 32,
                             gas=100_000)], 16),
        "stack_cap": (CORPUS["stack_cap"], "durango",
                      [lane(CORPUS["stack_cap"], gas=g)
                       for g in (100_000, 150, 10)], 8),
        "undefined_ap2": (_UNDEFINED_AP2, "ap2",
                          [lane(_UNDEFINED_AP2, gas=g)
                           for g in (100_000, 5_000)], 8),
        "context": (_CONTEXT_CODE, "durango",
                    [lane(_CONTEXT_CODE, gas=g, value=12345)
                     for g in (1_000_000, 150_000)], 16),
    }


EXEC_BATCHES = _exec_batches()


def _exec_inputs(code, fork, lanes, scache_cap):
    """The lanes as one batch of 8 (padding inactive), packed by the
    port's K5 packer, with their kdig digests."""
    env = C.env(A.BlockEnv)
    runner = A.MachineRunner(fork, env, C.resolver_for(lanes), device="cpu")
    txs = [A.TxSpec(code=ln["code"], calldata=ln["calldata"], gas=ln["gas"],
                    value=ln["value"], caller=ln["caller"],
                    address=ln["address"], origin=ln["caller"],
                    gas_price=C.GAS_PRICE,
                    storage={C._norm(k): (v, v)
                             for k, v in ln["storage"].items()})
           for ln in lanes]
    p = tM.MachineParams(fork=fork, batch=8, code_cap=512, data_cap=128,
                         scache_cap=scache_cap)
    inputs = runner.pack(txs, p)
    kd = np.zeros((1, 8, SP.KDIG_CAP, 16), dtype=np.int32)
    reqs = SP.spec_requests(code, fork)
    A.fill_kdig(kd, [(0, i, t, env, reqs) for i, t in enumerate(txs)]
                if reqs else [])
    inputs["kdig"] = torch.from_numpy(kd[0])
    return p, inputs


@pytest.mark.parametrize("name", sorted(EXEC_BATCHES))
def test_spec_exec_matches_reference(name):
    code, fork, lanes, S = EXEC_BATCHES[name]
    assert SP.trace_eligible(code, fork)[0]
    p, inputs = _exec_inputs(code, fork, lanes, S)
    storage = tuple(inputs[k] for k in ("skey", "sval", "sorig", "sflag",
                                        "scnt"))
    active = inputs["active"].bool()
    got = SP.build_spec_exec(SP.SpecProgram(code, fork), p)(
        inputs, storage, active)
    rp = jM.MachineParams(fork=fork, batch=8, code_cap=512, data_cap=128,
                          scache_cap=S)
    jin = {k: jnp.asarray(v.numpy()) if torch.is_tensor(v) else v
           for k, v in inputs.items()}
    want = jSP.build_spec_exec(jSP.SpecProgram(code, fork), rp)(
        jin, tuple(jin[k] for k in ("skey", "sval", "sorig", "sflag",
                                    "scnt")), jnp.asarray(active.numpy()))
    for f in tM._OCC_RES:
        assert np.array_equal(got[f].numpy(), np.asarray(want[f])), f
    n = len(lanes)
    statuses = set(got["status"][:n].tolist())
    assert (got["status"][n:] == tM.SKIP).all()
    assert (got["steps"][:n] > 0).all() and (got["steps"][n:] == 0).all()
    expect = {"erc20": {tM.STOP, tM.REVERT, tM.ERR},
              "pool": {tM.STOP, tM.REVERT, tM.ERR},
              "branch": {tM.STOP, tM.REVERT, tM.ERR},
              "slot_fan": {tM.HOST, tM.ERR},
              "stack_cap": {tM.HOST, tM.ERR},
              "undefined_ap2": {tM.ERR}}.get(name)
    if expect is not None:
        assert statuses == expect, statuses
    if name in ("slot_fan", "stack_cap"):
        hosty = got["status"] == tM.HOST
        want_reason = tM.R_SCACHE if name == "slot_fan" else tM.R_STACK
        assert (got["host_reason"][hosty] == want_reason).all()


# ---------------------------------------------------------------- window
W, G = C.WINDOW_BLOCKS, 64


@pytest.fixture(scope="module")
def ref_windows():
    """The reference's window program per program set (compiled once
    for each)."""
    fns = {}

    def get(codes):
        if codes not in fns:
            p = jM.MachineParams(fork="durango", features=_ALL_FEATURES,
                                 **C.WINDOW_SHAPE)
            occ = jM.OccParams(blocks=W, table_cap=G,
                               rounds=C.WINDOW_SHAPE["batch"] + 1)
            fns[codes] = jM.get_occ_machine(p, occ, tuple(
                jSP.SpecProgram(c, "durango") for c in codes))
        return fns[codes]
    return get


def _window_both(get, pk):
    spec = pk["spec"]
    codes = tuple(s.code for s in spec)
    got = tM.occ_run_plain(pk["p"], pk["occ"], pk["table"], pk["key_tab"],
                           pk["inputs"], spec)
    inputs = {k: jnp.asarray(v.numpy()) for k, v in pk["inputs"].items()}
    inputs["active"] = inputs["active"].astype(bool)
    want = get(codes)(jnp.asarray(pk["table"].numpy()),
                      jnp.asarray(pk["key_tab"].numpy()), inputs)
    jp = np.asarray(want["packed"])
    bad = np.argwhere(got["packed"].numpy() != jp)
    assert bad.size == 0, f"packed differs at (block, lane, col) {bad[:5]}"
    assert np.array_equal(got["table"].numpy(), np.asarray(want["table"]))
    return got


@pytest.mark.parametrize("name", sorted(C.WINDOW_CASES))
def test_window_with_programs_matches_reference(ref_windows, name):
    pk = C.pack_window(name, spec_codes=C.SPEC_CODES)
    assert tuple(s.code for s in pk["spec"]) == C.SPEC_CODES
    assert pk["p"] == tM.MachineParams(fork="durango", **C.WINDOW_SHAPE)
    got = _window_both(ref_windows, pk)
    prog = pk["inputs"]["prog_id"]
    active = pk["inputs"]["active"].bool()
    assert (prog[active] >= 0).any()
    if name in ("errors", "host_and_miss"):   # traced beside generic
        assert (prog[active] < 0).any()
    # the traced run equals the generic run of the same window
    generic = tM.occ_run_plain(*(C.pack_window(name)[k] for k in (
        "p", "occ", "table", "key_tab", "inputs")))
    assert torch.equal(generic["table"], got["table"])
    assert torch.equal(generic["packed"], got["packed"])


def test_mixed_window_matches_reference(ref_windows):
    """Traced, REVERT, flush-OOG and generic (computed-jump) lanes in
    one window, under the shared program set (the kdig-overflow and
    full-cache lanes of the card's mixed window are in the exec test)."""
    pk = C.pack_window(C.k7_window(fans=False), spec_codes=C.SPEC_CODES)
    assert pk["p"] == tM.MachineParams(fork="durango", **C.WINDOW_SHAPE)
    assert tuple(s.code for s in pk["spec"]) == C.SPEC_CODES
    got = _window_both(ref_windows, pk)
    prog = pk["inputs"]["prog_id"][:2]
    active = pk["inputs"]["active"][:2].bool()
    assert sorted(set(prog[active].tolist())) == [-1, 0, 1]
    st = got["packed"][:2, :, 0]
    assert st[0, 2] == tM.REVERT and st[0, 6] == tM.ERR
    assert (st[active & (prog < 0)] == tM.STOP).all()
    # the kdig slots of the token lanes hold the host keccaks of its two
    # requests; the other lanes have none
    kd = pk["inputs"]["kdig"][:2]
    tok = prog == 0
    assert (kd[tok][:, :2] != 0).any(dim=-1).all()
    assert (kd[tok][:, 2:] == 0).all() and (kd[~tok] == 0).all()


def test_run_occ_window_on_cpu_takes_the_program_set():
    pk = C.pack_window("swap", spec_codes=C.SPEC_CODES)
    launches = tM.OCC_LAUNCHES, tM.SPEC_LAUNCHES
    args = (pk["p"], pk["occ"], pk["table"], pk["key_tab"], pk["inputs"])
    out = tM.run_occ_window(*args, pk["spec"])
    plain = tM.occ_run_plain(*args, pk["spec"])
    assert (tM.OCC_LAUNCHES, tM.SPEC_LAUNCHES) == launches
    for k in ("table", "packed", "steps"):
        assert torch.equal(out[k], plain[k])
    bad = dict(pk["inputs"], kdig=pk["inputs"]["kdig"][:, :, :4])
    with pytest.raises(ValueError, match="kdig"):
        tM.run_occ_window(*args[:4], bad, pk["spec"])


@pytest.mark.parametrize("n_progs", [0, 1])
def test_prog_id_past_the_program_set_raises(n_progs):
    """A lane whose prog_id names no program of the set is the caller's
    fault: the plain version raises (the kernel traps) instead of
    escaping the lane HOST."""
    pk = C.pack_window("swap", spec_codes=C.SPEC_CODES)
    spec = pk["spec"][:n_progs]
    inputs = dict(pk["inputs"], prog_id=pk["inputs"]["prog_id"].clone())
    inputs["prog_id"][0, 0] = n_progs
    args = (pk["p"], pk["occ"], pk["table"], pk["key_tab"], inputs)
    with pytest.raises(ValueError, match="past the program set"):
        tM.run_occ_window(*args, spec)


# ------------------------------------------------------------ end to end
COUNTERS = ("lanes_specialized", "specialize_escapes", "programs_traced",
            "windows", "window_attempts", "rounds", "host_txs")


@pytest.fixture
def spec_env(monkeypatch):
    """The reference's default machine configuration, K7 included."""
    monkeypatch.setenv("CORETH_DEVICE_OCC", "1")
    monkeypatch.setenv("CORETH_SPECIALIZE", "1")
    monkeypatch.setenv("CORETH_NO_TOKEN_FASTPATH", "1")
    monkeypatch.setenv("CORETH_SERIAL_SHORTCIRCUIT", "0")
    radapter.RECIPES.clear()
    A.RECIPES.clear()
    yield monkeypatch
    # the replays' learned recipes must not premap later tests' lanes
    radapter.RECIPES.clear()
    A.RECIPES.clear()


def _port_replay(pgen, rblocks, window, specialize):
    A.RECIPES.clear()
    store = StateStore()
    pgb = pgen.to_block(store)
    port = ReplayEngine(CFG, store, parent_header=pgb.header, capacity=256,
                        batch_pad=64, window=4, device="cpu",
                        specialize=specialize, token_fastpath=False,
                        serial_shortcircuit=False)
    if window is not None:
        port._machine_executor().WINDOW = window
    roots = _record_flushes(port.commit_pipe)
    assert port.replay([Block.decode(b.encode()) for b in rblocks]) == \
        rblocks[-1].header.root
    port.close()
    return port, roots


def _ab(env, n_blocks, txs_of, extra=None, window=None):
    """The reference with K7 and the port with and without it replay
    the chain: equal fold roots, equal counters."""
    rgen, pgen, rblocks = _chains(n_blocks, txs_of, extra)
    ref, ref_roots = _ref_replay(env, rgen, rblocks, window)
    port, roots = _port_replay(pgen, rblocks, window, True)
    assert roots == ref_roots
    rm, c = ref._machine, port._machine.counters()
    rc = rm.machine_counters()
    assert {k: c[k] for k in COUNTERS} == {
        k: rc[k] if k in rc else getattr(rm, k) for k in COUNTERS}
    generic, groots = _port_replay(pgen, rblocks, window, False)
    assert groots == roots
    gc = generic._machine.counters()
    assert gc["lanes_specialized"] == gc["programs_traced"] == 0
    assert c["lanes_specialized"] > 0 and c["programs_traced"] >= 1
    return c


def _tx(k, to, kind, arg, gas=200_000, value=0):
    return (k, to, kind, arg, gas, value)


def test_erc20_machine_matches_reference(spec_env):
    """Fresh recipients every block: keccak mapping keys from kdig, the
    revert branch a traced leaf; windows of 2 blocks."""
    c = _ab(spec_env, 4, lambda i: [
        _tx(k, TOKEN, "transfer", (bytes([0x80 + i]) + bytes([k]) * 19,
                                   3 + k)) for k in range(6)], window=2)
    assert c["blocks"] == 4 and c["host_txs"] == 0
    assert c["specialize_escapes"] == 0 and c["programs_traced"] == 1


def test_swap_full_conflict_matches_reference(spec_env):
    """Every swap conflicts through the pool's reserves: the traced
    program re-runs inside the device OCC rounds."""
    c = _ab(spec_env, 4, lambda i: [
        _tx(k, POOL, "swap", 1000 + 17 * i + k) for k in range(6)],
        window=2)
    assert c["host_txs"] == 0 and c["rounds"] > 0


def test_mixed_and_revert_matches_reference(spec_env):
    """Token, pool and plain transfers in one block, plus a transfer
    whose amount exceeds the sender's balance (the traced REVERT
    leaf)."""
    _ab(spec_env, 3, lambda i: [
        _tx(0, POOL, "swap", 500 + i),
        _tx(1, TOKEN, "transfer", (b"\x45" * 20, 77)),
        _tx(2, TOKEN, "transfer", (b"\x46" * 20, 10**24)),
        _tx(3, bytes([0x47]) * 20, "raw", b"", 21_000, 5)])


def test_unresolvable_jump_escapes_match_reference(spec_env):
    """A computed-jump contract stays on the interpreter (counted in
    specialize_escapes) while token lanes of the same blocks run their
    traced program."""
    jumper = b"\x79" * 20
    extra = {jumper: (0, 1, chip_smoke.JUMPER_CODE)}
    c = _ab(spec_env, 3, lambda i: [
        _tx(0, jumper, "raw", (4).to_bytes(32, "big"), 100_000),
        _tx(1, TOKEN, "transfer", (ADDRS[(i + 2) % 8], 11)),
        _tx(2, jumper, "raw", (4).to_bytes(32, "big"), 100_000)],
        extra=extra)
    assert c["specialize_escapes"] >= 6 and c["lanes_specialized"] >= 3
    assert c["programs_traced"] == 1


# ------------------------------------------------------- generated CUDA
# The generated unit built for the host by tests/occ_host_build.py (each
# CTA of the window's cluster a host thread).
@pytest.fixture(scope="module")
def gxx():
    if H.gxx() is None:
        pytest.skip("needs g++")


def _gxx(tmp, spec, out=None, *flags):
    r = H.build(str(tmp), SP.cuda_source(spec), out, *flags)
    assert r.returncode == 0, r.stderr[:4000]


@pytest.mark.parametrize("name", ["token", "pool", "keccak_fan"])
def test_generated_cuda_compiles(gxx, tmp_path, name):
    spec = (SP.SpecProgram(CORPUS[name], "durango"),)
    src = SP.cuda_source(spec)
    assert "spec_prog_0" in src and "spec_prog_1" not in src
    assert '#include "occ_window.cu"' in src
    _gxx(tmp_path, spec, None, "-fsyntax-only")


def test_generated_cuda_runs_like_the_plain_version(gxx, tmp_path):
    """The host build of K6+K7 for the mixed window's program set
    against ``occ_run_plain`` (tolerance 0) on that window, the shared
    set's swap and errors windows, and a generic build on a window with
    every prog_id -1."""
    cases = [C.pack_window(C.k7_window(), spec_codes=C.k7_spec_codes()),
             C.pack_window("swap", spec_codes=C.SPEC_CODES),
             C.pack_window("errors", spec_codes=C.SPEC_CODES),
             C.pack_window("raw_chain")]
    libs = {}
    for pk in cases:
        spec = pk["spec"]
        if spec not in libs:
            out = tmp_path / f"lib{len(libs)}"
            out.mkdir()
            _gxx(out, spec, str(out / "libk.so"), "-O1")
            libs[spec] = ctypes.CDLL(str(out / "libk.so"))
            kernels._declare("occ_window", libs[spec])
        args = (pk["p"], pk["occ"], pk["table"], pk["key_tab"], pk["inputs"])
        largs, got = tM.occ_launch_args(*args)
        assert libs[spec].occ_window_launch(*tM.pointers(largs), None) == 0
        want = tM.occ_run_plain(*args, spec)
        for k in ("table", "packed", "steps"):
            assert torch.equal(got[k], want[k]), k
