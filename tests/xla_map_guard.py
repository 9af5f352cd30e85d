"""Keeps a pytest worker under the kernel's limit on memory mappings.

Every program XLA compiles for the CPU holds about 1600 memory mappings
for as long as JAX keeps it, and a process may hold
``vm.max_map_count`` (65530) of them.  tests/test_shard_replay.py alone
reaches 59929 after its 23rd case in one process; under
``pytest -n 6 --dist load`` one worker can take most of that file after
other JAX tests and pass the limit, and XLA then segfaults.  After any
test that leaves its process past half the limit, this hook frees what
JAX holds (``jax.clear_caches``); later tests compile again or read
JAX's disk cache.  Below half the limit it does nothing.

Loaded by ``pytest_plugins`` in tests/test_torch_shard_occ.py, whose
added tests change how ``--dist load`` splits the suite into the
workers' chunks.
"""

import gc
import sys


def _past_half_the_limit() -> bool:
    try:
        with open("/proc/sys/vm/max_map_count") as f:
            limit = int(f.read())
        with open("/proc/self/maps") as f:
            held = sum(1 for _ in f)
    except (OSError, ValueError):
        return False
    return held > limit // 2


def pytest_runtest_teardown(item, nextitem):
    jax = sys.modules.get("jax")
    if jax is not None and _past_half_the_limit():
        jax.clear_caches()
        gc.collect()
