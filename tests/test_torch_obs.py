"""The port's span tracer and metrics on the CPU, against the JAX
reference.

Mirrors the cases of tests/test_obs.py that need no streaming pipeline
(the metrics satellites, the tracer core, the disabled contract, the
export file and its ``obs/export_fail`` point, the supervisor's
transitions in the event stream), then holds the port to the reference
where both can see the same inputs: the Chrome trace export of one
sequence of spans on one injected clock, and the Prometheus text of the same registry contents.  Last, the spans a
traced port replay emits (and the ``torch.profiler`` labels of
``device_span``), and ``publish_metrics``' gauges against ``stats``.
"""

import json
import os
import sys
import threading

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import pytest

from coreth_tpu import metrics as rmetrics
from coreth_tpu.obs import trace as rtrace

from coreth_tpu_torch import faults, obs
from coreth_tpu_torch import metrics as tmetrics
from coreth_tpu_torch.faults import FaultPlan, FaultSpec
from coreth_tpu_torch.metrics import (
    Counter, Gauge, Registry, render_prometheus,
)
from coreth_tpu_torch.obs import trace as ttrace
from coreth_tpu_torch.obs.trace import _FLOW, _NULL_SPAN
from coreth_tpu_torch.replay.supervisor import BackendSupervisor
from coreth_tpu_torch.types import Block

import test_shard_replay as SR
from test_torch_trie_backend import _engine


@pytest.fixture(autouse=True)
def _clean_tracer_state():
    """No tracer (or fault plan) may leak across tests: the module
    global is the whole enabled / disabled contract."""
    obs.uninstall()
    rtrace.uninstall()
    yield
    obs.uninstall()
    rtrace.uninstall()
    faults.disarm()


# -------------------------------------------------------------- metrics

def test_prometheus_help_lines():
    reg = Registry()
    reg.get_or_register("serve/quarantined", Counter,
                        description="blocks applied but unverified")
    reg.get_or_register("serve/undocumented", Counter)
    reg.get_or_register("supervisor/device/demoted", Gauge,
                        description="1 while the scope is demoted")
    text = render_prometheus(reg)
    assert "# HELP serve_quarantined blocks applied but unverified" in text
    assert "# HELP supervisor_device_demoted 1 while the scope" in text
    assert "# TYPE supervisor_device_demoted gauge" in text
    assert "# HELP serve_undocumented" not in text
    assert "# TYPE serve_quarantined counter" in text


def _fill(pkg) -> object:
    reg = pkg.Registry()
    pkg.get_or_register("replay/blocks", pkg.Counter, reg,
                        description="blocks replayed").inc(7)
    pkg.get_or_register("replay/t_trie", pkg.Gauge, reg).update(0.25)
    pkg.get_or_register("9lives.x", pkg.Gauge, reg,
                        description="a name led by a digit").update(2)
    c = pkg.get_or_register("supervisor/native/strikes", pkg.Counter, reg)
    c.inc()
    c.inc(2)
    return reg


def test_render_prometheus_matches_reference():
    """The same instruments and values in both packages' registries
    render to the same text."""
    got = tmetrics.render_prometheus(_fill(tmetrics))
    assert got == rmetrics.render_prometheus(_fill(rmetrics))
    assert "\n_9lives_x 2\n" in got
    assert "supervisor_native_strikes 3" in got


def test_disabled_metrics_are_noops(monkeypatch):
    from coreth_tpu_torch.metrics import registry
    monkeypatch.setattr(registry, "ENABLED", False)
    c, g = Counter(), Gauge()
    c.inc(3)
    g.update(2.0)
    assert (c.value, g.value) == (0, 0.0)


# ---------------------------------------------------------- tracer core

def test_disabled_mode_is_noop():
    assert obs.tracer() is None
    assert obs.span("anything", blocks=3) is _NULL_SPAN
    assert obs.device_span("anything") is _NULL_SPAN
    assert obs.instant("anything") is None
    assert obs.write_out() is None
    assert obs.arm_from_env() is None  # env unset -> stays off
    with obs.span("still-a-noop"):
        pass
    assert obs.tracer() is None
    # a tracer without device_spans keeps the launches unlabelled
    obs.install()
    assert obs.device_span("k") is _NULL_SPAN


def test_span_nesting_and_thread_flow_isolation():
    tr = obs.install()

    def worker(flow):
        with tr.span("outer", flow=flow):
            with tr.span("inner"):      # no explicit flow: inherits
                pass

    threads = [threading.Thread(target=worker, args=(f,))
               for f in (101, 202)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    evs = tr.export()["traceEvents"]
    inner = [e for e in evs if e.get("name") == "inner"]
    assert sorted(e["args"]["flow"] for e in inner) == [101, 202]
    outer = {e["args"]["flow"]: e["tid"] for e in evs
             if e.get("name") == "outer"}
    for e in inner:
        assert e["tid"] == outer[e["args"]["flow"]]
    assert _FLOW.get() is None


def test_ring_bounds_under_sustained_load():
    tr = obs.install(ring=64)
    for i in range(500):
        tr.instant("tick", i=i)
    assert len(tr._ring) == 64 and tr.dropped == 500 - 64
    ticks = [e for e in tr.export()["traceEvents"] if e["name"] == "tick"]
    assert len(ticks) == 64 and ticks[0]["args"]["i"] == 500 - 64


def test_event_ring_mirrors_into_tracer():
    ring = obs.EventRing("unit", maxlen=4)
    ring.append("a:1")            # tracing off: deque only
    assert list(ring) == ["a:1"] and "a:1" in ring
    tr = obs.install()
    ring.append("b:2")            # tracing on: mirrored as an instant
    names = [e["name"] for e in tr.export()["traceEvents"]]
    assert "unit/b:2" in names and "unit/a:1" not in names
    for i in range(10):
        ring.append(f"c:{i}")
    assert len(ring) == 4
    ring.clear()
    assert len(ring) == 0


def test_export_prunes_dead_thread_names():
    tr = obs.install(ring=8)

    def emit(label):
        threading.current_thread().name = label
        tr.instant("tick")

    for i in range(6):
        t = threading.Thread(target=emit, args=(f"dead-{i}",))
        t.start()
        t.join()
    for _ in range(16):
        tr.instant("flood")
    named = {e["args"]["name"] for e in tr.export()["traceEvents"]
             if e["ph"] == "M"}
    assert not any(n.startswith("dead-") for n in named)
    assert len(tr._thread_names) == 1


def test_arm_from_env(monkeypatch):
    monkeypatch.setenv("CORETH_TRACE", "1")
    monkeypatch.setenv("CORETH_TRACE_RING", "")
    t = obs.arm_from_env()
    assert t is not None and t.ring_size == 65536
    obs.uninstall()
    monkeypatch.setenv("CORETH_TRACE_RING", "128")
    t1 = obs.arm_from_env()
    assert t1 is obs.arm_from_env() is obs.tracer()
    assert t1.ring_size == 128


def test_trace_out_written_and_loadable(tmp_path, monkeypatch):
    out = tmp_path / "trace.json"
    monkeypatch.setenv("CORETH_TRACE_OUT", str(out))
    tr = obs.install()
    with obs.span("replay/issue_window", blocks=2, flow=5):
        obs.instant("x")
    assert obs.write_out() == str(out)
    doc = json.loads(out.read_text())
    assert {e["name"] for e in doc["traceEvents"]} >= {
        "replay/issue_window", "x", "block", "thread_name"}
    assert tr.export_failures == 0


def test_export_fail_fault_counted(tmp_path, monkeypatch):
    """The ``obs/export_fail`` point: the trace-file write fails — the
    failure is counted, nothing half-written, and a replay traced by the
    same tracer finishes unharmed on its root."""
    out = tmp_path / "trace.json"
    monkeypatch.setenv("CORETH_TRACE_OUT", str(out))
    tr = obs.install()
    blocks = SR._build_chain(2, SR._gen_transfer)
    eng, _store = _engine()
    with faults.armed(FaultPlan({"obs/export_fail": FaultSpec()})):
        root = eng.replay([Block.decode(b.encode()) for b in blocks])
        assert obs.write_out() is None
    assert root == blocks[-1].header.root
    assert tr.export_failures == 1 and not out.exists()


# ------------------------------------------------ against the reference

def _script(mod, clock):
    """One sequence of spans, instants and a flow on the tracer of
    ``mod`` (either package's trace module)."""
    tr = mod.install(mod.SpanTracer(clock=clock))
    with mod.span("replay/issue_window", blocks=3):
        clock.t += 0.002
        with mod.span("commit/flush", flow=9, blocks=3):
            clock.t += 0.001
            mod.instant("machine/dirty_block", number=9)
    clock.t += 0.004
    with mod.span("machine/window_complete", flow=9):
        clock.t += 0.003
    ring = mod.EventRing("shard", maxlen=8)
    ring.append("dispatch:1")
    doc = tr.export()
    mod.uninstall()
    for e in doc["traceEvents"]:
        e["pid"] = 0
        e.pop("tid")   # each package counts its own thread ids
    return doc


class _Clock:
    def __init__(self):
        self.t = 50.0

    def __call__(self):
        return self.t


def test_export_matches_reference():
    doc = _script(ttrace, _Clock())
    assert doc == _script(rtrace, _Clock())
    assert [e["ph"] for e in doc["traceEvents"]
            if e["name"] == "block"] == ["s", "t", "f"]


def test_supervisor_transitions_match_reference():
    """tests/test_obs.py:403/:421: the last transition record, and the
    transitions in the event stream, equal in both packages."""
    from coreth_tpu.replay.supervisor import BackendSupervisor as RSup
    names = []
    for mod, sup_cls in ((obs, BackendSupervisor), (rtrace, RSup)):
        tr = mod.install()
        t = [0.0]
        sup = sup_cls(clock=lambda: t[0], sleep=lambda s: None)
        sup.strikes_to_demote = 1
        assert sup.snapshot()["last_transition"] is None
        sup.strike("native", RuntimeError("boom"))
        assert sup.snapshot()["last_transition"] == {
            "kind": "demote", "scope": "native", "at_s": 0.0}
        t[0] = sup.cooldown + 1
        sup.note_ok("native")
        assert sup.snapshot()["last_transition"] == {
            "kind": "promote", "scope": "native", "at_s": t[0]}
        names.append([(e["name"], e.get("args"))
                      for e in tr.export()["traceEvents"]
                      if e["ph"] == "i"])
        mod.uninstall()
    assert names[0] == names[1] == [
        ("supervisor/demote", {"scope": "native"}),
        ("supervisor/promote", {"scope": "native"})]


# ------------------------------------------------------ a traced replay

def test_traced_replay_spans_and_device_labels(monkeypatch):
    """A traced replay (transfer blocks, then machine blocks on K6, then
    a host-path block) emits the replay's spans; with ``device_spans``
    the launches run inside their ``torch.profiler.record_function``
    labels (recorded here by a stand-in: the profiler itself costs
    seconds on the plain versions' ops; ``chip_smoke.py`` phase trace
    reads the labels from a real profile on the card)."""
    import torch.profiler
    labels = []

    class Label:
        def __init__(self, name):
            labels.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Label)
    transfers = SR._build_chain(2, SR._gen_transfer)
    machine = SR._build_chain(2, SR._gen_erc20)
    tr = obs.install(device_spans=True)
    eng, _store = _engine()
    eng.replay([Block.decode(b.encode()) for b in transfers])
    meng, _store = _engine(machine=True)
    meng.replay([Block.decode(b.encode()) for b in machine])
    eng2, _store = _engine(machine=True)
    eng2.supervisor.strike("device", RuntimeError("routing"), hard=True)
    eng2.replay([Block.decode(b.encode()) for b in machine[:1]])
    doc = json.loads(json.dumps(tr.export()))
    spans = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    instants = {e["name"] for e in doc["traceEvents"] if e["ph"] == "i"}
    assert spans >= {"replay/issue_window", "replay/complete_window",
                     "commit/flush", "machine/execute_run",
                     "machine/window_issue", "machine/window_complete",
                     "replay/host_fallback", "hostexec/native_call"}
    assert instants >= {"replay/sender_issue", "supervisor/demote"}
    assert set(labels) == {"coreth/transfer_window", "coreth/occ_window"}


def test_untraced_replay_records_nothing():
    blocks = SR._build_chain(2, SR._gen_transfer)
    eng, _store = _engine()
    eng.replay([Block.decode(b.encode()) for b in blocks])
    assert obs.tracer() is None


def test_publish_metrics_gauges_equal_stats():
    blocks = SR._build_chain(2, SR._gen_transfer)
    eng, _store = _engine()
    eng.replay([Block.decode(b.encode()) for b in blocks])
    reg = Registry()
    eng.publish_metrics(reg)
    eng.supervisor.publish(reg)
    row = eng.stats.row()
    assert {n: m.value for n, m in reg.each()
            if n.startswith("replay/")} == {f"replay/{k}": v
                                           for k, v in row.items()}
    assert reg.get("supervisor/strikes").value == 0
    text = render_prometheus(reg)
    assert f"replay_blocks_device {row['blocks_device']}" in text
