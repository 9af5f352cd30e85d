"""Fault injection, backend supervision and quarantine in the port, on
the CPU, against the JAX reference.

Mirrors tests/test_faults.py (the registry, the supervisor's ladder,
the engine scenarios that need no streaming pipeline: the streaming
``test_persistent_device_fault_demotes`` is a direct ``replay`` here,
the shard cases run on ``make_mesh(2)``), the oracle cases of
tests/test_hostexec.py:328 (the statetests corpus through the port's
bridge with ``host_exec_check``) and the reference's tolerant
``quarantine_block``.  Chains come from the reference's builder
(tests/test_shard_replay.py's), so a root equal to the header is the
reference's root.

The port's supervisor strikes only on injected faults (and, in the
``native`` scope, the hostexec session's own errors): a kernel that
raises propagates out of ``replay`` with no strike
(``test_kernel_error_propagates_without_strike``), where the
reference's would strike and take the host path.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import pytest

from coreth_tpu import faults as rfaults
from coreth_tpu.replay.supervisor import BackendSupervisor as RSupervisor
from coreth_tpu.types import Block as RBlock

from coreth_tpu_torch import faults
from coreth_tpu_torch.evm import EVM, BlockContext, TxContext
from coreth_tpu_torch.evm.device import adapter as tadapter
from coreth_tpu_torch.evm.device import machine as M
from coreth_tpu_torch.evm.hostexec import bridge
from coreth_tpu_torch.evm.hostexec.backend import SessionError
from coreth_tpu_torch.faults import FaultInjected, FaultPlan, FaultSpec
from coreth_tpu_torch.metrics import Registry
from coreth_tpu_torch.params import TEST_CHAIN_CONFIG as CFG
from coreth_tpu_torch.parallel import make_mesh
from coreth_tpu_torch.replay import ReplayEngine, ReplayError
from coreth_tpu_torch.replay import engine as tengine
from coreth_tpu_torch.replay.supervisor import (
    BackendFault, BackendSupervisor,
)
from coreth_tpu_torch.state import StateDB, StateStore
from coreth_tpu_torch.types import Block
from coreth_tpu_torch.workloads import erc20 as terc20
from coreth_tpu_torch.workloads import hot_contract as thot

import test_shard_replay as SR
import test_torch_host as H
from test_torch_trie_backend import _engine


@pytest.fixture(autouse=True)
def _clean_fault_state():
    """No plan may leak out of a test, and no process-wide observer."""
    yield
    faults.disarm()
    rfaults.disarm()
    bridge.set_fault_observer(None)


def _fast(strikes=1, cooldown=60.0, retries=1):
    """The reference tests' ``_fast_supervisor_env`` as keywords."""
    return BackendSupervisor(retries=retries, backoff=0.001,
                             strikes=strikes, cooldown=cooldown,
                             sleep=lambda s: None)


def _fresh(blocks):
    return [Block.decode(b.encode()) for b in blocks]


# ------------------------------------------------------------- registry

def test_unarmed_points_are_noops():
    for pkg in (faults, rfaults):
        assert pkg.check("device/dispatch") is None
        assert pkg.fire("device/dispatch") is None
        assert pkg.fired() == {}


PLANS = {
    "after_times": ({"p": {"after": 2, "times": 2}}, 7, 6),
    "prob": ({"p": {"prob": 0.5}}, 3, 64),
    "prob_times": ({"p": {"prob": 0.3, "times": 5, "after": 1}}, 11, 64),
    "two_points": ({"p": {"prob": 0.5}, "q": {"after": 3, "prob": 0.7}},
                   5, 40),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_semantics_match_reference(name):
    """The same plan and seed fire on the same hits in both packages
    (after / times / prob; two points share the plan's RNG)."""
    points, seed, hits = PLANS[name]

    def run(pkg):
        plan = pkg.FaultPlan({k: dict(v) for k, v in points.items()},
                             seed=seed)
        with pkg.armed(plan):
            seq = [(p, pkg.check(p) is not None)
                   for _ in range(hits) for p in sorted(points)]
        return seq, plan.fired()

    assert run(faults) == run(rfaults)
    if name == "after_times":
        assert [f for _p, f in run(faults)[0]] == \
            [False, False, True, True, False, False]


def test_seed_matters_and_replays():
    def draw(seed):
        plan = FaultPlan({"q": FaultSpec(prob=0.5)}, seed=seed)
        with faults.armed(plan):
            return [faults.check("q") is not None for _ in range(32)]
    assert draw(3) == draw(3) != draw(4)


def test_fire_raises_with_transience():
    with faults.armed(FaultPlan({"p": FaultSpec(transient=True)})):
        with pytest.raises(FaultInjected) as ei:
            faults.fire("p")
    assert ei.value.transient and ei.value.point == "p"
    assert str(ei.value) == str(rfaults.FaultInjected("p", transient=True))


@pytest.mark.parametrize("spec", [{"action": "sigkill"},
                                  {"action": "stall", "delay": 0.1}])
def test_plan_with_an_action_is_refused(spec):
    """Only raising points exist in the port: a plan asking the
    reference's other actions fails loudly instead of doing nothing."""
    with pytest.raises(TypeError):
        FaultPlan({"p": spec})


def test_arm_from_env(monkeypatch, tmp_path):
    faults.disarm()
    monkeypatch.setenv("CORETH_FAULT_PLAN",
                       '{"seed": 3, "points": {"x/y": {"times": 1}}}')
    plan = faults.arm_from_env()
    assert plan is not None and "x/y" in plan.points and plan.seed == 3
    assert faults.arm_from_env() is plan      # idempotent
    faults.disarm()
    f = tmp_path / "plan.json"
    f.write_text('{"p": {"after": 1}}')
    monkeypatch.setenv("CORETH_FAULT_PLAN", "@" + str(f))
    assert faults.arm_from_env().points["p"].after == 1
    faults.disarm()
    # the engine arms it at construction, as the reference's does
    eng, _store = _engine()
    assert faults.registry._PLAN.points["p"].after == 1
    eng.close()


COVERAGE = {
    "device/dispatch": "test_torch_faults::test_persistent_device_fault_"
                       "demotes",
    "device/shard_exchange": "test_torch_faults::test_shard_exchange_fault_"
                             "demotes",
    "device/key_exchange": "test_torch_faults::test_key_exchange_fault_"
                           "demotes",
    "native/error_rc": "test_torch_faults::test_native_error_rc",
    "native/session_loss": "test_torch_faults::test_native_session_loss",
    "native/oracle_divergence": "test_torch_faults::test_oracle_divergence_"
                                "hard_demotes",
    "commit/flush_fail": "test_torch_faults::test_commit_flush_transient_"
                         "retries",
    "recover/fault": "test_torch_faults::test_recover_fault_degrades",
    "obs/export_fail": "test_torch_obs::test_export_fail_fault_counted",
    "flat/torn_write": "test_torch_checkpoint::test_torn_flat_write_retries",
    "flat/stale_generation": "test_torch_checkpoint::test_stale_generation_"
                             "handout_skipped",
    "checkpoint/crash_gap": "test_torch_checkpoint::test_torn_checkpoint_"
                            "keeps_previous",
}


def test_declared_points_all_covered():
    """The completeness gate (tests/test_faults.py:107) over the points
    the port declares: each is armed by the named test, which exists."""
    import importlib
    for mod in ("evm.device.adapter", "evm.device.shard",
                "evm.hostexec.backend", "evm.hostexec.bridge", "obs.trace",
                "replay.commit", "replay.engine", "state.flat.store",
                "state.flat.exporter", "replay.checkpoint"):
        importlib.import_module(f"coreth_tpu_torch.{mod}")
        importlib.import_module(f"coreth_tpu.{mod}")
    assert set(faults.declared()) == set(COVERAGE)
    for point, where in COVERAGE.items():
        module, name = where.split("::")
        assert hasattr(importlib.import_module(module), name), where
        # the port's point is the reference's, doc and all
        assert faults.declared()[point] == rfaults.declared()[point]


# ----------------------------------------------------------- supervisor

def _both_supervisors():
    now = [100.0]
    port = BackendSupervisor(clock=lambda: now[0], sleep=lambda s: None,
                             strikes=2, cooldown=10.0)
    ref = RSupervisor(clock=lambda: now[0], sleep=lambda s: None)
    ref.strikes_to_demote, ref.cooldown = 2, 10.0
    return now, port, ref


def test_supervisor_demote_probe_promote_cycle():
    """tests/test_faults.py:153's sequence on both supervisors with one
    injected clock: the same routing answers and equal snapshots at
    every step."""
    now, port, ref = _both_supervisors()
    exc = RuntimeError("boom")

    def step(action, scope="device", advance=0.0):
        now[0] += advance
        for sup in (port, ref):
            if action == "strike":
                sup.strike(scope, exc)
            elif action == "ok":
                sup.note_ok(scope)
        assert port.snapshot() == ref.snapshot()
        assert port.allows(scope) == ref.allows(scope)
        assert port.demoted(scope) == ref.demoted(scope)
        return port.allows(scope)

    assert step("strike")                  # one strike: still healthy
    assert not step("strike")              # demoted
    assert not step(None, advance=5)       # cooling
    assert step(None, advance=6)           # probe window open
    assert not step("strike")              # failed probe
    assert port.demotions == 2
    assert not step(None, advance=15)      # doubled cooldown (20 s)
    assert step(None, advance=10)
    step("ok")                             # probe success
    assert not port.demoted("device") and port.promotions == 1
    step("strike", scope="native")
    step("strike", scope="native", advance=1)
    assert port.snapshot()["demote_latency_s"] == {"device": 0.0,
                                                   "native": 1.0}


def test_supervisor_keywords_are_the_reference_env(monkeypatch):
    """The reference's CORETH_SUPERVISOR_* defaults are the keywords'
    defaults, and set values land on the same attributes."""
    keys = ("max_retries", "backoff", "strikes_to_demote", "cooldown")
    port, ref = BackendSupervisor(), RSupervisor()
    assert [getattr(port, k) for k in keys] == [getattr(ref, k) for k in keys]
    for env, val in (("RETRIES", "4"), ("BACKOFF", "0.5"),
                     ("STRIKES", "7"), ("COOLDOWN", "9")):
        monkeypatch.setenv(f"CORETH_SUPERVISOR_{env}", val)
    port = BackendSupervisor(retries=4, backoff=0.5, strikes=7, cooldown=9)
    ref = RSupervisor()
    assert [getattr(port, k) for k in keys] == [getattr(ref, k) for k in keys]


def test_supervisor_transient_retry_then_success():
    counts = []
    for pkg, sup in ((faults, _fast(retries=3)),
                     (rfaults, RSupervisor(sleep=lambda s: None))):
        sup.max_retries = 3
        plan = pkg.FaultPlan({"p": pkg.FaultSpec(times=2, transient=True)})
        with pkg.armed(plan):
            assert sup.run("device", "p", lambda: 42) == 42
        counts.append((sup.retries, sup.strikes))
    assert counts[0] == counts[1] == (2, 0)


def test_supervisor_persistent_fault_raises_backend_fault():
    sup = _fast()
    with faults.armed(FaultPlan({"p": FaultSpec()})):
        with pytest.raises(BackendFault) as ei:
            sup.run("device", "p", lambda: 42)
    assert sup.demoted("device") and isinstance(ei.value.cause,
                                                FaultInjected)


def test_supervisor_strikes_only_on_faults():
    """The deliberate difference from the reference: the device and
    commit scopes strike on injected faults alone; the native scope
    also on the session's own errors, retried like transient faults."""
    sup = _fast(retries=2)
    for scope in ("device", "commit"):
        for exc in (RuntimeError("CUDA error"), MemoryError("OOM"),
                    SessionError("no session")):
            def boom(exc=exc):
                raise exc
            with pytest.raises(type(exc)):
                sup.run(scope, None, boom)
    assert sup.strikes == sup.retries == 0

    def bug():
        raise ValueError("a Python error in the native path")
    with pytest.raises(ValueError):
        sup.run("native", None, bug)
    calls = []

    def lost():
        calls.append(1)
        raise SessionError("no session")
    with pytest.raises(BackendFault):
        sup.run("native", None, lost)
    assert (len(calls), sup.retries, sup.strikes) == (3, 2, 1)
    assert sup.demoted("native")


# ------------------------------------------------- engine ladder, K1/K2

@pytest.fixture(scope="module")
def transfers():
    return SR._build_chain(6, SR._gen_transfer)


def test_transient_device_fault_retries_bit_identical(transfers):
    eng, _store = _engine(supervisor=_fast(strikes=3))
    with faults.armed(FaultPlan({"device/dispatch":
                                 FaultSpec(times=1, transient=True)})):
        assert eng.replay(_fresh(transfers)) == transfers[-1].header.root
    assert eng.supervisor.retries >= 1 and eng.supervisor.demotions == 0
    assert eng.stats.blocks_device == len(transfers)


def test_persistent_device_fault_demotes(transfers):
    """tests/test_faults.py:236 as a direct replay: every block on the
    host path, the root exact, the demotion in the metrics registry."""
    eng, _store = _engine(supervisor=_fast())
    with faults.armed(FaultPlan({"device/dispatch": FaultSpec()})) as plan:
        assert eng.replay(_fresh(transfers)) == transfers[-1].header.root
    assert plan.fired()["device/dispatch"] >= 1
    assert eng.stats.blocks_fallback == len(transfers)
    assert eng.stats.blocks_device == 0
    snap = eng.supervisor.snapshot()
    assert snap["demotions"] >= 1 and "device" in snap["demoted_scopes"]
    reg = Registry()
    eng.supervisor.publish(reg)
    assert reg.get("supervisor/demotions").value >= 1


def test_demoted_device_repromotes_after_cooldown(transfers):
    eng, _store = _engine(supervisor=_fast())
    with faults.armed(FaultPlan({"device/dispatch": FaultSpec(times=1)})):
        eng.replay(_fresh(transfers[:3]))
        assert eng.supervisor.demoted("device")
        assert eng.stats.blocks_fallback > 0
        eng.supervisor._state["device"]["until"] = 0.0  # cooldown lapsed
        root = eng.replay(_fresh(transfers[3:]))
    assert root == transfers[-1].header.root
    assert eng.supervisor.promotions >= 1
    assert not eng.supervisor.demoted("device")
    assert eng.stats.blocks_device > 0


def test_recover_fault_degrades(transfers):
    """Sender recovery faults degrade to per-tx recovery, on the device
    ladder (its plain version here) and in ``warm_senders``."""
    eng, _store = _engine(supervisor=_fast())
    eng.recover_device, eng.DEVICE_RECOVER_MIN = True, 1
    with faults.armed(FaultPlan({"recover/fault": FaultSpec()})) as plan:
        eng.warm_senders(_fresh(transfers[:1]))
        root = eng.replay(_fresh(transfers))
        assert plan.fired()["recover/fault"] >= 2
    assert root == transfers[-1].header.root
    assert eng.stats.sigs_device == eng.stats.sigs_host == 0
    assert eng.supervisor.strikes == 0


def test_commit_flush_transient_retries(transfers):
    eng, _store = _engine(supervisor=_fast(strikes=5, retries=3))
    with faults.armed(FaultPlan({"commit/flush_fail":
                                 FaultSpec(times=2, transient=True)})):
        assert eng.replay(_fresh(transfers)) == transfers[-1].header.root
    assert eng.supervisor.retries >= 2
    # a PERSISTENT flush failure is fatal (no other commit backend)
    eng2, _store = _engine(supervisor=_fast())
    with faults.armed(FaultPlan({"commit/flush_fail": FaultSpec()})):
        with pytest.raises(FaultInjected):
            eng2.replay(_fresh(transfers))
    assert eng2.supervisor.strikes == 1


@pytest.mark.parametrize("path", ["transfer_window", "occ_window"])
def test_kernel_error_propagates_without_strike(monkeypatch, path):
    """A kernel wrapper that raises (a build error, a CUDA error) makes
    ``replay`` raise that error, with no strike and no block on the
    host path."""
    def boom(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access")

    if path == "transfer_window":
        monkeypatch.setattr(tengine, "_transfer_window", boom)
        blocks, machine = SR._build_chain(2, SR._gen_transfer), False
    else:
        monkeypatch.setattr(M, "run_occ_window", boom)
        blocks, machine = SR._build_chain(2, SR._gen_erc20), True
    eng, _store = _engine(machine=machine)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        eng.replay(_fresh(blocks))
    assert eng.supervisor.strikes == 0
    assert eng.stats.blocks_fallback == 0


# ------------------------------------------- engine ladder, K6/K7 and K9

def test_machine_occ_device_fault_demotes():
    """The fused-OCC dispatch (``MachineWindowRunner.issue``) under a
    persistent fault: struck, demoted, the swap chain on the host
    path with exact roots."""
    blocks = SR._build_chain(3, SR._gen_swap)
    eng, _store = _engine(machine=True, supervisor=_fast())
    with faults.armed(FaultPlan({"device/dispatch": FaultSpec()})):
        assert eng.replay(_fresh(blocks)) == blocks[-1].header.root
    assert eng.supervisor.demotions >= 1
    assert eng.stats.blocks_fallback == len(blocks)


def test_shard_exchange_fault_demotes():
    """The shards' exchange seam (K9's flags reduce) on a 2-shard mesh."""
    blocks = SR._build_chain(3, SR._gen_erc20)
    eng, _store = _engine(machine=True, mesh=make_mesh(2),
                          supervisor=_fast())
    with faults.armed(FaultPlan({"device/shard_exchange":
                                 FaultSpec()})) as plan:
        assert eng.replay(_fresh(blocks)) == blocks[-1].header.root
        assert plan.fired()["device/shard_exchange"] >= 1
    assert eng.supervisor.strikes >= 1 and eng.supervisor.demotions >= 1


def test_key_exchange_fault_demotes():
    """tests/test_faults.py:327: the key-range replica sync of a hot
    contract on a 2-shard mesh (windows of 2, threshold 3), persistent:
    struck, demoted, the chain finished on the host path."""
    genesis, blocks = thot.build_hot_chain(CFG, 4, 6, n_keys=8)
    store = StateStore()
    gblock = genesis.to_block(store)
    eng = ReplayEngine(CFG, store, parent_header=gblock.header,
                       capacity=256, batch_pad=64, window=4, device="cpu",
                       mesh=make_mesh(2), token_fastpath=False,
                       serial_shortcircuit=False, keyrange_threshold=3,
                       supervisor=_fast())
    eng._machine_executor().WINDOW = 2
    with faults.armed(FaultPlan({"device/key_exchange":
                                 FaultSpec()})) as plan:
        assert eng.replay(_fresh(blocks)) == blocks[-1].header.root
        assert plan.fired()["device/key_exchange"] >= 1
    assert eng.supervisor.strikes >= 1 and eng.supervisor.demotions >= 1
    assert eng.stats.blocks_fallback > 0


def test_mid_run_fault_keeps_the_finished_prefix():
    """A fault at the last window dispatch of a run (windows of two
    blocks, so earlier windows' blocks are finished by then): they stay
    committed, the device scope is struck once, and the rest of the run
    re-enters the loop on the device, to the exact root.  (A fault
    before any block finished propagates to the engine's supervised
    call instead, which strikes again and sends the run's first block
    to the host path, as the reference does.)"""
    blocks = SR._build_chain(6, SR._gen_erc20)

    def run(spec):
        tadapter.RECIPES.clear()      # the same discovery launches
        eng, _store = _engine(machine=True, supervisor=_fast(strikes=3))
        with faults.armed(FaultPlan({"device/dispatch": spec})) as plan:
            assert eng.replay(_fresh(blocks)) == blocks[-1].header.root
        return eng, plan.fired(), plan._hits["device/dispatch"]

    _eng, _fired, hits = run(FaultSpec(times=0))   # counts the hits
    eng, fired, _hits = run(FaultSpec(after=hits - 1, times=1))
    assert fired == {"device/dispatch": 1}
    assert eng.supervisor.strikes == 1 and eng.supervisor.demotions == 0
    assert eng.stats.blocks_fallback == 0
    assert eng._machine.blocks == len(blocks)


# ------------------------------------------------------ native boundary

@pytest.fixture(scope="module")
def swaps():
    return SR._build_chain(3, SR._gen_swap)


def _warm_token_probe(blocks):
    """Run the token fast path's exec-gas probe for ``blocks``' rules
    before a plan is armed: ``measure_transfer_exec_gas`` makes bridge
    calls of its own the first time a process sees a fork schedule (it
    caches per process), and those calls would take the plan's hits,
    with no observer to strike, ahead of the replay's own."""
    for b in blocks:
        for variant in ("noop", "set", "reset"):
            terc20.measure_transfer_exec_gas(CFG, b.number, b.time, variant)


def _hits_inside(monkeypatch, obj, name: str, point: str) -> list:
    """Wrap ``obj.name`` to record, per call, how many hits of ``point``
    fired inside it."""
    inside = []
    real = getattr(obj, name)

    def spy(*a, **kw):
        before = faults.fired(point)
        try:
            return real(*a, **kw)
        finally:
            inside.append(faults.fired(point) - before)

    monkeypatch.setattr(obj, name, spy)
    return inside


def _host_engine(strikes, **kw):
    """An engine whose device scope is demoted for good: every block on
    the host path, every contract call through the hostexec bridge (the
    reference tests' ``CORETH_MACHINE=0``)."""
    sup = _fast(strikes=strikes, cooldown=1e9)
    sup.strike("device", RuntimeError("routing"), hard=True)
    eng, _store = _engine(supervisor=sup, **kw)
    return eng


def test_native_session_loss(swaps, monkeypatch):
    eng = _host_engine(1)
    _warm_token_probe(swaps)
    inside = _hits_inside(monkeypatch, eng, "_fallback",
                          "native/session_loss")
    bridge.reset_counters()
    with faults.armed(FaultPlan({"native/session_loss":
                                 FaultSpec()})) as plan:
        assert eng.replay(_fresh(swaps)) == swaps[-1].header.root
        assert plan.fired()["native/session_loss"] >= 1
        # every hit came from the replay's host path
        assert sum(inside) == plan.fired()["native/session_loss"]
    assert bridge.counters()["session_faults"] >= 1
    assert eng.supervisor.demoted("native")


def test_native_error_rc(swaps, monkeypatch):
    eng = _host_engine(2)
    _warm_token_probe(swaps)
    inside = _hits_inside(monkeypatch, eng, "_fallback", "native/error_rc")
    bridge.reset_counters()
    with faults.armed(FaultPlan({"native/error_rc": FaultSpec()})) as plan:
        assert eng.replay(_fresh(swaps)) == swaps[-1].header.root
        assert plan.fired()["native/error_rc"] >= 2
        assert sum(inside) == plan.fired()["native/error_rc"]
    assert bridge.counters()["native_faults"] >= 2
    assert eng.supervisor.demoted("native")


def test_serial_shortcircuit_error_rc_strikes_native(swaps, monkeypatch):
    """The serial short-circuit's session under an error rc: the native
    scope struck, the block on the per-block path (K5's plain version),
    its root exact.  The token gas probe is warm before the plan is
    armed, so its one hit lands inside the serial session, whatever ran
    earlier in the process."""
    eng, _store = _engine(supervisor=_fast(strikes=1), device_occ=False)
    _warm_token_probe(swaps[:1])
    inside = _hits_inside(monkeypatch, eng._machine_executor(),
                          "_execute_serial_run", "native/error_rc")
    with faults.armed(FaultPlan({"native/error_rc":
                                 FaultSpec(times=1)})) as plan:
        assert eng.replay(_fresh(swaps[:1])) == swaps[0].header.root
        assert plan.fired()["native/error_rc"] == 1
        assert inside == [1]
    assert eng.supervisor.demoted("native")
    assert eng._machine.serial_blocks == 0


def test_oracle_divergence_hard_demotes(swaps, monkeypatch):
    """An armed-oracle divergence hard-demotes ``native`` at once; the
    interpreter's result is authoritative and the replay exact."""
    eng = _host_engine(99, host_exec_check=True)
    _warm_token_probe(swaps)
    inside = _hits_inside(monkeypatch, eng, "_fallback",
                          "native/oracle_divergence")
    bridge.reset_counters()
    with faults.armed(FaultPlan({"native/oracle_divergence":
                                 FaultSpec(times=1)})) as plan:
        assert eng.replay(_fresh(swaps)) == swaps[-1].header.root
        assert plan.fired()["native/oracle_divergence"] == 1
        assert sum(inside) == 1
    assert eng.supervisor.demoted("native")
    assert bridge.counters()["oracle_divergences"] == 1


def test_oracle_armed_replay_checks_every_native_call(swaps):
    eng = _host_engine(3, host_exec_check=True)
    bridge.reset_counters()
    assert eng.replay(_fresh(swaps)) == swaps[-1].header.root
    c = bridge.counters()
    assert c["oracle_checks"] == c["native_calls"] > 0
    assert not eng.supervisor.demoted("native")


@pytest.mark.parametrize("fixture_file", H._fixture_files())
def test_statetests_corpus_with_host_exec_check(monkeypatch, fixture_file):
    """tests/test_hostexec.py:328 on the port: every fixture through the
    bridge with the oracle armed (no supervisor: a divergence raises),
    each subtest's post root and logs hash the fixture's."""
    real = H._pre_state

    def checked(pre):
        store = real(pre)
        store.host_exec_check = True
        return store

    monkeypatch.setattr(H, "_pre_state", checked)
    bridge.reset_counters()
    H.test_state_fixture_through_port(fixture_file)
    c = bridge.counters()
    assert c.get("oracle_checks", 0) >= c.get("native_calls", 0)
    assert not c.get("oracle_divergences")


# ------------------------------------ the oracle leaves the StateDB alone

def _view(sdb: StateDB) -> tuple:
    """Everything a StateDB holds, its store's tries included."""
    objs = tuple(sorted(
        (a, o.account.rlp(), tuple(sorted(o.origin_storage.items())),
         tuple(sorted(o.dirty_storage.items())),
         tuple(sorted(o.pending_storage.items())),
         tuple(sorted(o.written_storage.items())), o.suicided, o.deleted,
         o.fresh, o.dirty_code, o.code)
        for a, o in sdb._objects.items()))
    return (objs, len(sdb._journal), dict(sdb._dirty_counts), sdb.refund,
            [(lg.rlp_items(), lg.index, lg.tx_index) for lg in sdb.logs],
            sdb._log_index, sorted(sdb.access_list_addresses),
            sorted(sdb.access_list_slots), dict(sdb.transient),
            sorted(sdb.created_this_tx), sorted(sdb._pending),
            sorted(sdb._destructed), sorted(sdb._storage_tries),
            sdb.storage_gen, sdb.account_gen, sdb.store.trie.hash(),
            {a: t.hash() for a, t in sdb.store.storage.items()})


@pytest.mark.parametrize("plant", [False, True])
def test_oracle_leaves_the_statedb_unchanged(monkeypatch, plant):
    """Token transfers through ``EVM.call`` with the oracle armed: around
    every differential check the StateDB (overlay, journal, logs,
    refund, access lists, counters, the store's tries) is exactly as
    before; a planted divergence (gas off by one) raises with the
    StateDB unchanged too."""
    sender, holder, token = b"\x51" * 20, b"\x52" * 20, b"\x77" * 20
    store = StateStore()
    sdb = StateDB(store)
    acct = terc20.token_genesis_account({sender: 10**6})
    sdb.set_code(token, acct.code)
    for k, v in acct.storage.items():
        sdb.set_state(token, k, v)
    sdb.add_balance(sender, 10**18)
    sdb.commit()
    store.host_exec_check = True
    sdb = StateDB(store)
    ctx = BlockContext(coinbase=b"\x01" * 20, gas_limit=8_000_000, number=1,
                       time=10, base_fee=25 * 10**9)
    evm = EVM(ctx, TxContext(origin=sender, gas_price=30 * 10**9), sdb, CFG)
    seen = []
    real = bridge._differential_check

    def spy(evm_, caller, addr, input_, gas, value, res):
        before = _view(evm_.statedb)
        if plant:
            res.gas_left += 1
        try:
            real(evm_, caller, addr, input_, gas, value, res)
        finally:
            seen.append(before == _view(evm_.statedb))

    monkeypatch.setattr(bridge, "_differential_check", spy)
    for i in range(3):
        sdb.set_tx_context(bytes([i]) * 32, i)
        sdb.add_slot_to_access_list(token, b"\x07" * 32)
        call = lambda: evm.call(  # noqa: E731
            sender, token,
            terc20.transfer_calldata(holder, 10 + i), 100_000, 0)
        if plant:
            with pytest.raises(AssertionError, match="divergence"):
                call()
        else:
            _ret, _gas, err = call()
            assert err is None
        sdb.finalise(True)
    assert seen and all(seen)
    if not plant:
        assert sdb.get_state(token, terc20.balance_slot(holder)) \
            == (10 + 11 + 12).to_bytes(32, "big")


def test_statedb_copy_only_reads_its_store():
    store = StateStore()
    sdb = StateDB(store)
    sdb.add_balance(b"\x61" * 20, 5)
    cp = sdb.copy()
    cp.add_balance(b"\x61" * 20, 7)
    assert (sdb.get_balance(b"\x61" * 20), cp.get_balance(b"\x61" * 20)) \
        == (5, 12)
    for write in (lambda: cp.intermediate_root(True), cp.commit,
                  cp.restore):
        with pytest.raises(RuntimeError, match="cannot write"):
            write()


# ------------------------------------------------------------ quarantine

def _poison(block, kind, cls=Block):
    bad = cls.decode(block.encode())
    if kind in ("receipt", "receipt_root"):
        bad.header.receipt_hash = b"\xde\xad\xbe\xef" * 8
    if kind in ("root", "receipt_root"):
        bad.header.root = b"\x11" * 32
    if kind == "gas":
        bad.header.gas_used += 1
    return bad


@pytest.mark.parametrize("kind", ["receipt", "gas", "root", "receipt_root"])
def test_quarantine_block_matches_reference(kind):
    """A poison block (a header that lies about its body) through both
    packages' ``quarantine_block``: the same reasons and the same root
    (the computed post-state); the next block then replays strictly on
    both to its header's root."""
    blocks = SR._build_chain(2, SR._gen_mixed)
    db = SR.Database()
    rgb = SR.Genesis(config=SR.CFG, gas_limit=8_000_000,
                     alloc=SR._alloc()).to_block(db)
    ref = SR.ReplayEngine(SR.CFG, db, rgb.root, parent_header=rgb.header,
                          capacity=256, batch_pad=64, window=4)
    rbad = _poison(blocks[0], kind, RBlock)
    reasons = ref.quarantine_block(rbad)
    port, store = _engine()
    assert port.quarantine_block(_fresh([rbad])[0]) == reasons
    assert reasons
    assert port.root == ref.root == store.trie.hash() \
        == blocks[0].header.root
    assert port.stats.blocks_quarantined == ref.stats.blocks_quarantined \
        == 1
    assert port.supervisor.quarantined == ref.supervisor.quarantined == 1
    with pytest.raises(ReplayError):
        port._fallback(_fresh([_poison(blocks[1], kind)])[0])
    ref._fallback(blocks[1])
    assert port.replay(_fresh(blocks[1:])) == ref.root \
        == blocks[1].header.root
