"""K5 (the EVM step machine): the port's plain version against the JAX
reference, on the CPU.

Every case of tests/torch_machine_cases.py runs as one batch through
the reference ``MachineRunner`` and the port's ``MachineRunner(device=
"cpu")`` (miss-and-rerun rounds included): the TxResults must be
equal, and so must the packed output rows of the final round — every
column of every lane, padding and ERR/REVERT/HOST lanes included.
Integer results: tolerance 0.  Both runners use one shared shape
(``_SHAPE``) so the reference compiles its machine once per fork.
"""

import ctypes
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import pytest
import torch

from coreth_tpu.evm.device import adapter as jadapter
from coreth_tpu.evm.device import machine as jM
from coreth_tpu.evm.device import tables as jtables
from coreth_tpu_torch.evm.device import adapter as tadapter
from coreth_tpu_torch.evm.device import machine as tM
from coreth_tpu_torch.evm.device import tables as ttables

import occ_host_build as H
import torch_machine_cases as C
from coreth_tpu_torch import kernels

_SHAPE = dict(batch=8, code_cap=512, data_cap=128, scache_cap=16)
_ALL_FEATURES = frozenset(jtables.FEATURE_OPS.values())


class _RefRunner(jadapter.MachineRunner):
    def _params(self, txs):
        return jM.MachineParams(fork=self.fork, features=_ALL_FEATURES,
                                **_SHAPE)


class _PortRunner(tadapter.MachineRunner):
    def _params(self, txs):
        return tM.MachineParams(fork=self.fork, **_SHAPE)


def _run_both(fork, lanes):
    resolve = C.resolver_for(lanes)
    ref = _RefRunner(fork, C.env(jadapter.BlockEnv), resolve)
    port = _PortRunner(fork, C.env(tadapter.BlockEnv), resolve,
                       device="cpu")
    rtx, ttx = C.specs(lanes, jadapter.TxSpec), C.specs(lanes,
                                                       tadapter.TxSpec)
    want, got = ref.run(rtx), port.run(ttx)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.__dict__ == w.__dict__, f"lane {i}"
    # the final round's packed rows, from the resolved pre-states
    jp = ref._params(rtx)
    jrows = np.asarray(jM.get_machine(jp)(ref._pack(rtx, jp))["packed"])
    tp = port._params(ttx)
    trows, _steps = tM.run_machine(tp, port.pack(ttx, tp))
    assert trows.shape == jrows.shape == (tp.batch, tp.width)
    bad = np.argwhere(trows.numpy() != jrows)
    assert bad.size == 0, f"packed rows differ at (lane, col) {bad[:5]}"
    return got, port


@pytest.mark.parametrize("name", sorted(C.CASES))
def test_machine_case_matches_reference(name):
    got, port = _run_both("durango", C.CASES[name])
    assert port.launches >= 1 and port.steps > 0


@pytest.mark.parametrize("name", sorted(C.CANCUN_CASES))
def test_machine_cancun_case_matches_reference(name):
    _run_both("cancun", C.CANCUN_CASES[name])


def test_machine_outcomes_cover_every_status_and_escape():
    """The catalog reaches STOP, REVERT, ERR and each capacity escape."""
    statuses, reasons = set(), set()
    for fork, cases in (("durango", C.CASES), ("cancun", C.CANCUN_CASES)):
        for lanes in cases.values():
            port = _PortRunner(fork, C.env(tadapter.BlockEnv),
                               C.resolver_for(lanes), device="cpu")
            for r in port.run(C.specs(lanes, tadapter.TxSpec)):
                statuses.add(r.status)
                reasons.add(r.host_reason)
    assert {tM.STOP, tM.REVERT, tM.ERR, tM.HOST} <= statuses
    assert {tM.R_MEM, tM.R_KECCAK, tM.R_STACK, tM.R_SCACHE, tM.R_LOG,
            tM.R_COPY, tM.R_TCACHE} <= reasons


def test_step_bound_escapes_host():
    """A lane still running at max_steps ends HOST/R_STEPS (a small
    bound keeps the plain loop short)."""
    lanes = [C.lane("5b" + C.push(0) + "56")]          # jump-to-self
    p = tM.MachineParams(fork="durango", max_steps=40, **_SHAPE)
    port = _PortRunner("durango", C.env(tadapter.BlockEnv),
                       C.resolver_for(lanes), device="cpu")
    packed, steps = tM.run_machine(
        p, port.pack(C.specs(lanes, tadapter.TxSpec), p))
    out = tadapter.PackedOut(packed.numpy(), p)
    assert out.status[0] == tM.HOST and out.host_reason[0] == tM.R_STEPS
    assert int(steps[0]) == 40 and out.status[1] == tM.SKIP


def test_tables_match_reference():
    for fork in ttables.FORKS:
        a, b = jtables.op_tables(fork), ttables.op_tables(fork)
        for k in ("const_gas", "nin", "nout", "supported"):
            assert np.array_equal(getattr(a, k), getattr(b, k)), (fork, k)
    for lanes in C.CASES.values():
        for ln in lanes:
            ri = jtables.scan_code(ln["code"], "durango")
            ti = ttables.scan_code(ln["code"], "durango")
            assert (ri.eligible, ri.features, ri.jumpdests) == \
                (ti.eligible, ti.features, ti.jumpdests)


def test_runner_refuses_ineligible_code_and_cuda_without_card():
    port = _PortRunner("durango", C.env(tadapter.BlockEnv),
                       lambda a, k: 0, device="cpu")
    with pytest.raises(ValueError, match="not device-eligible"):
        port.run(C.specs([C.lane("31" + "00")], tadapter.TxSpec))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tadapter.MachineRunner("durango", C.env(tadapter.BlockEnv),
                                   lambda a, k: 0)


# --------------------------------------------------- host build of K5
@pytest.fixture(scope="module")
def host_k5(tmp_path_factory):
    """K5's ``csrc/step_machine.cu`` built for the host
    (``tests/occ_host_build.py``'s shims): each CTA of the launch a host
    thread with one thread, which runs the CTA's lanes one after the
    other in its slot, each CTA's dynamic shared memory a buffer."""
    if H.gxx() is None:
        pytest.skip("needs g++")
    tmp = tmp_path_factory.mktemp("host_k5")
    out = tmp / "libstep_machine.so"
    r = H.build(str(tmp), '#include "step_machine.cu"\n', str(out), "-O1")
    assert r.returncode == 0, r.stderr[:4000]
    lib = ctypes.CDLL(str(out))
    kernels._declare("step_machine", lib)
    return lib


@pytest.mark.parametrize("mem_cap,layout", [(4096, 1), (1 << 18, 0)])
@pytest.mark.parametrize("fork,B", [("durango", 1), ("durango", 17),
                                    ("cancun", 17)])
def test_host_build_of_k5_matches_plain(host_k5, fork, B, mem_cap, layout):
    """K5 from the CUDA source, built for the host, against the plain
    version: packed rows and step counts of every lane.  A lane's arena
    fits a shared-memory slot at mem_cap 4096 (layout 1), not at 256 KiB
    (layout 0: the arenas in device memory); 17 lanes are more than one
    CTA's.  ``step_machine_group`` picks the layout by shape and the
    launch refuses the other."""
    p = tM.MachineParams(fork=fork, batch=B, mem_cap=mem_cap,
                         code_cap=512, data_cap=128, scache_cap=16)
    runner = _PortRunner(fork, C.env(tadapter.BlockEnv),
                         lambda a, k: 0, device="cpu")
    inputs = runner.pack(C.batch_lanes(fork, B, tadapter.TxSpec), p)
    grp = np.zeros(4, dtype=np.int32)
    assert host_k5.step_machine_group(tM._dims(p, inputs).ctypes.data,
                                      grp.ctypes.data) == 0
    lpc, ctas, smem, got_layout = grp.tolist()
    assert got_layout == layout and ctas == -(-B // lpc) and ctas >= min(B, 2)
    assert smem == layout * lpc * (tM._dims(p, inputs)[17] // 4 | 1) * 4
    args, packed, steps = tM.machine_launch_args(p, inputs, layout)
    assert host_k5.step_machine_launch(*tM.pointers(args), None) == 0
    plain = tM.run_plain(p, inputs)
    assert torch.equal(packed, plain["packed"])
    assert torch.equal(steps, plain["steps"])
    wrong, _, _ = tM.machine_launch_args(p, inputs, 1 - layout)
    assert host_k5.step_machine_launch(*tM.pointers(wrong), None) == -3


def test_host_build_of_k5_sha3_offsets_and_lengths(host_k5):
    """K5's in-lane SHA3 (32-bit words from the lane's shared-memory
    slot), built for the host, on ``torch_machine_cases.sha3_lanes``
    (offsets 0-3, lengths around 136, the memory's last bytes): packed
    rows and step counts equal to the plain version's."""
    lanes = C.sha3_lanes()
    txs = C.specs(lanes, tadapter.TxSpec)
    runner = _PortRunner("durango", C.env(tadapter.BlockEnv),
                         C.resolver_for(lanes), device="cpu")
    p = tM.MachineParams(fork="durango", batch=128, code_cap=256,
                         data_cap=512, scache_cap=16)
    inputs = runner.pack(txs, p)
    args, packed, steps = tM.machine_launch_args(p, inputs, 1)
    assert host_k5.step_machine_launch(*tM.pointers(args), None) == 0
    plain = tM.run_plain(p, inputs)
    assert torch.equal(packed, plain["packed"])
    assert torch.equal(steps, plain["steps"])
    assert (packed[:len(txs), 0] == tM.STOP).all()
