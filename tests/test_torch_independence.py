"""The port stands alone: no JAX, nothing of the reference package, and
no silent fall back to the CPU."""

import ast
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "coreth_tpu")


def _port_sources():
    root = os.path.join(REPO, "coreth_tpu_torch")
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "main_ab.py")


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", None) == "__import__" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def test_no_file_imports_jax_or_the_reference():
    files = list(_port_sources())
    assert len(files) > 20
    # the fault, metrics and span layer is scanned with the rest
    scanned = {os.path.relpath(os.path.dirname(p), REPO) for p in files}
    assert {os.path.join("coreth_tpu_torch", d)
            for d in ("faults", "metrics", "obs")} <= scanned
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            if mod.split(".")[0] in FORBIDDEN:
                bad.append(f"{os.path.relpath(path, REPO)}: {mod}")
    assert not bad, bad


def test_every_kernel_wrapper_is_scanned():
    """Each CUDA source under csrc/ is launched from a wrapper module
    that the import scan above covers (K6's ``run_occ_window`` too)."""
    from coreth_tpu_torch import kernels
    texts = {path: open(path).read() for path in _port_sources()}
    for name, src in kernels.SOURCES.items():
        assert os.path.exists(os.path.join(kernels.CSRC, src)), src
        users = [p for p, t in texts.items()
                 if f'kernels.load("{name}")' in t]
        assert users, f"no scanned wrapper launches {name}"


_REPLAY_SCRIPT = r"""
import sys
import coreth_tpu_torch.chain as C
from coreth_tpu_torch.crypto.secp256k1 import priv_to_address
from coreth_tpu_torch.params import TEST_CHAIN_CONFIG as CFG
from coreth_tpu_torch.replay import ReplayEngine
from coreth_tpu_torch.state import StateStore
from coreth_tpu_torch.types import Block, DynamicFeeTx, sign_tx

keys = [0x2000 + i for i in range(4)]
addrs = [priv_to_address(k) for k in keys]
genesis = C.Genesis(config=CFG, gas_limit=8_000_000,
                    alloc={a: C.GenesisAccount(balance=10**24) for a in addrs})
store = StateStore()
gb = genesis.to_block(store)
nonces = [0] * 4

def gen(i, bg):
    for j in range(4):
        bg.add_tx(sign_tx(DynamicFeeTx(
            chain_id_=CFG.chain_id, nonce=nonces[j], gas_tip_cap_=10**9,
            gas_fee_cap_=300 * 10**9, gas=21_000, to=addrs[(j + 1) % 4],
            value=7 + i), keys[j], CFG.chain_id))
        nonces[j] += 1

blocks, _ = C.generate_chain(CFG, gb, store, 4, gen, gap=2)
s2 = StateStore()
g2 = genesis.to_block(s2)
engine = ReplayEngine(CFG, s2, parent_header=g2.header, capacity=64,
                      batch_pad=8, window=2, device="cpu")
root = engine.replay([Block.decode(b.encode()) for b in blocks])
engine.close()
assert root == blocks[-1].header.root
assert engine.stats.blocks_device == 4
if len(sys.argv) > 1:
    # armed from the environment at the engine's construction
    from coreth_tpu_torch import faults, obs
    assert faults.fired() == {"device/dispatch": 1}, faults.fired()
    assert engine.supervisor.retries == 1
    spans = {e["name"] for e in obs.tracer().export()["traceEvents"]}
    assert {"replay/issue_window", "commit/flush"} <= spans, spans
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "coreth_tpu"))
assert not bad, bad
print("OK")
"""


def test_cpu_replay_subprocess_loads_no_jax():
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "PYTHONPATH": REPO, "HOME": os.environ.get("HOME", "/tmp")}
    proc = subprocess.run([sys.executable, "-c", _REPLAY_SCRIPT], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")


def test_traced_faulted_replay_subprocess_loads_no_jax():
    """The same replay with the span tracer installed and a fault plan
    armed (both through the environment, ``CORETH_TRACE`` and
    ``CORETH_FAULT_PLAN``, as the engine's constructor reads them): the
    transient dispatch fault retried, the spans recorded, and still no
    JAX and nothing of the reference loaded."""
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "PYTHONPATH": REPO, "HOME": os.environ.get("HOME", "/tmp"),
           "CORETH_TRACE": "1",
           "CORETH_FAULT_PLAN": '{"points": {"device/dispatch": '
                                '{"times": 1, "transient": true}}}'}
    proc = subprocess.run([sys.executable, "-c", _REPLAY_SCRIPT, "armed"],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")


_IMPORT_SCRIPT = r"""
import importlib, os, sys
root = os.path.join(sys.argv[1], "coreth_tpu_torch")
for dirpath, _dirs, files in os.walk(root):
    for fn in sorted(files):
        if fn.endswith(".py"):
            rel = os.path.relpath(os.path.join(dirpath, fn), sys.argv[1])
            mod = rel[:-3].replace(os.sep, ".").replace(".__init__", "")
            importlib.import_module(mod)
from coreth_tpu_torch.crypto import native
from coreth_tpu_torch import kernels
assert native._lib is None, "importing loaded (or built) the native library"
assert not kernels._libs, "importing loaded a kernel library"
print("OK")
"""


def test_importing_the_port_builds_and_loads_nothing():
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "PYTHONPATH": REPO, "HOME": os.environ.get("HOME", "/tmp")}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_SCRIPT, REPO],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")


def test_entry_points_refuse_cpu_without_being_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is honoured")
    from coreth_tpu_torch import default_device
    from coreth_tpu_torch.params import TEST_CHAIN_CONFIG
    from coreth_tpu_torch.replay import ReplayEngine
    from coreth_tpu_torch.state import StateStore
    with pytest.raises(RuntimeError, match="CUDA"):
        default_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        ReplayEngine(TEST_CHAIN_CONFIG, StateStore())
    from coreth_tpu_torch.evm.device.adapter import MachineWindowRunner
    with pytest.raises(RuntimeError, match="CUDA"):
        MachineWindowRunner("durango", lambda addr, key: 0)
    from coreth_tpu_torch.mpt import SecureTrie
    from coreth_tpu_torch.mpt.rehash import device_rehash
    with pytest.raises(RuntimeError, match="CUDA"):
        device_rehash(SecureTrie())
    from coreth_tpu_torch.chain import Genesis
    from coreth_tpu_torch.params import TEST_APRICOT_PHASE5_CONFIG
    from coreth_tpu_torch.workloads import mixed
    with pytest.raises(RuntimeError, match="CUDA"):
        mixed.replay_engine(Genesis(config=TEST_APRICOT_PHASE5_CONFIG,
                                    gas_limit=8_000_000), 8, 0x7000)
    assert default_device("cpu").type == "cpu"
