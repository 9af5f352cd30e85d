"""K6 (the fused OCC window): the port's plain version against the JAX
reference, on the CPU.

Every window of tests/torch_machine_cases.py ``WINDOW_CASES`` is packed
once by the port's ``MachineWindowRunner`` (premaps, table rows, lane
inputs; numpy-made, no randomness) and run through the reference's
jitted ``get_occ_machine(p, occ)`` and the port's ``occ_run_plain``: the
final slot table and every packed column of every lane of every block —
the machine results and the committed / escape / pending / rounds
columns — must be equal (integers: tolerance 0).  All cases share one
shape, so the reference compiles its window program once (plus once for
the round-cap case, and once at 32 lanes for ``SWEEP_CASES``).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coreth_tpu.evm.device import machine as jM
from coreth_tpu.evm.device import tables as jtables
from coreth_tpu_torch.evm.device import machine as tM

import torch_machine_cases as C

_SHAPE = C.WINDOW_SHAPE
W, G = C.WINDOW_BLOCKS, 64
_ALL_FEATURES = frozenset(jtables.FEATURE_OPS.values())


def _jax_machine(rounds: int, batch: int = _SHAPE["batch"],
                 table_cap: int = G):
    p = jM.MachineParams(fork="durango", features=_ALL_FEATURES,
                         **dict(_SHAPE, batch=batch))
    return jM.get_occ_machine(p, jM.OccParams(blocks=W, table_cap=table_cap,
                                              rounds=rounds))


@pytest.fixture(scope="module")
def jax_occ():
    return _jax_machine(_SHAPE["batch"] + 1)


def pack_case(name: str) -> dict:
    pk = C.pack_window(name)
    p, occ = pk["p"], pk["occ"]
    assert (p.batch, p.code_cap, p.data_cap, p.scache_cap) == tuple(
        _SHAPE.values())
    assert (occ.blocks, occ.table_cap) == (W, G)
    return pk


def _run_both(fn, pk, occ=None):
    occ = occ or pk["occ"]
    got = tM.occ_run_plain(pk["p"], occ, pk["table"], pk["key_tab"],
                           pk["inputs"])
    inputs = {k: jnp.asarray(v.numpy()) for k, v in pk["inputs"].items()}
    inputs["active"] = inputs["active"].astype(bool)
    want = fn(jnp.asarray(pk["table"].numpy()),
              jnp.asarray(pk["key_tab"].numpy()), inputs)
    jt, jp = np.asarray(want["table"]), np.asarray(want["packed"])
    assert got["packed"].shape == jp.shape == (W, pk["p"].batch,
                                               pk["p"].width + 4)
    bad = np.argwhere(got["packed"].numpy() != jp)
    assert bad.size == 0, f"packed differs at (block, lane, col) {bad[:5]}"
    assert np.array_equal(got["table"].numpy(), jt)
    return got


def _cols(got, n_blocks):
    """(committed, escape, pending, rounds) per real block."""
    x = got["packed"][:n_blocks, :, -4:].numpy()
    return x[..., 0], x[..., 1], x[..., 2], x[:, 0, 3]


@pytest.mark.parametrize("name", sorted(C.WINDOW_CASES))
def test_occ_plain_matches_reference(jax_occ, name):
    pk = pack_case(name)
    got = _run_both(jax_occ, pk)
    blocks = C.WINDOW_CASES[name]
    nb = len(blocks)
    com, esc, pend, rounds = _cols(got, nb)
    # padding blocks never run: SKIP rows, 0 rounds
    assert (got["packed"][nb:, :, 0] == tM.SKIP).all()
    assert (got["packed"][nb:, :, -1] == 0).all()
    n = [len(b) for b in blocks]
    if name == "disjoint":
        assert rounds.tolist() == [1, 1] and com[0, :5].all()
    elif name == "raw_chain":
        assert rounds[0] > 1 and com[0, :6].all()
    elif name == "swap":
        assert rounds[0] == 6 and com[0, :6].all() and not pend.any()
    elif name == "host_and_miss":
        assert esc[0, :5].tolist() == [0, 1, 0, 1, 0]
        assert rounds[0] == 1
    elif name == "chained_blocks":
        assert all(com[b, :n[b]].all() for b in range(3))
    elif name == "errors":
        assert got["packed"][0, :4, 0].tolist() == [tM.ERR] * 3 + [tM.STOP]
    assert int(got["steps"].sum()) > 0


@pytest.fixture(scope="module")
def jax_occ_32():
    """The reference's window program at 32 lanes, by table cap."""
    progs = {}

    def get(table_cap: int):
        if table_cap not in progs:
            progs[table_cap] = _jax_machine(33, batch=32,
                                            table_cap=table_cap)
        return progs[table_cap]
    return get


@pytest.mark.parametrize("name", sorted(C.SWEEP_CASES))
def test_occ_plain_sweep_cases_match_reference(jax_occ_32, name):
    """The sweep cases the kernel's in-order walk over dependent lanes is
    pinned on (``torch_machine_cases.SWEEP_CASES``, 32 lanes a block),
    plain version against the reference: every packed column and the
    table equal."""
    pk = C.pack_window(name, batch=32)
    assert pk["occ"].blocks == W
    got = _run_both(jax_occ_32(pk["occ"].table_cap), pk)
    assert int(got["steps"].sum()) > 0


def test_occ_plain_unmapped_entries(jax_occ):
    """Cache entries whose table row is >= G are unused: their gathers
    read 0 and their scatters drop, whatever the value past G."""
    pk = pack_case("chained_blocks")
    sgid = pk["inputs"]["sgid"]
    assert (sgid[:, :, 8:] == G).all()
    sgid[:, :, 8] = G + 1
    sgid[:, :, 9] = G + 7
    sgid[:, :, 10] = 10**6
    got = _run_both(jax_occ, pk)
    com, _esc, _pend, _rounds = _cols(got, 3)
    assert com[:, :3].all()


@pytest.mark.parametrize("name,rounds", [("swap", 3),
                                         ("host_and_miss", 1)])
def test_occ_plain_round_cap(name, rounds):
    """A block still converging at the round cap leaves lanes pending
    (the third trailing column): a full-conflict block at 3 rounds, and
    a block whose only round both hits the cap and finds escapes."""
    pk = pack_case(name)
    occ = tM.OccParams(blocks=W, table_cap=G, rounds=rounds)
    got = _run_both(_jax_machine(rounds), pk, occ)
    com, esc, pend, rnd = _cols(got, 1)
    assert rnd[0] == rounds and pend[0].any()
    if name == "swap":
        assert pend[0].sum() == 3 and com[0].sum() == 3
    else:
        assert esc[0].sum() == 2


def test_run_occ_window_on_cpu_is_the_plain_version():
    pk = pack_case("raw_chain")
    launches = tM.OCC_LAUNCHES
    out = tM.run_occ_window(pk["p"], pk["occ"], pk["table"], pk["key_tab"],
                            pk["inputs"])
    plain = tM.occ_run_plain(pk["p"], pk["occ"], pk["table"],
                             pk["key_tab"], pk["inputs"])
    assert tM.OCC_LAUNCHES == launches
    for k in ("table", "packed", "steps"):
        assert torch.equal(out[k], plain[k])
    bad = dict(pk["inputs"], sgid=pk["inputs"]["sgid"][:, :, :4])
    with pytest.raises(ValueError, match="sgid"):
        tM.run_occ_window(pk["p"], pk["occ"], pk["table"], pk["key_tab"],
                          bad)
