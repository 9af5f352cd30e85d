"""Build machinery for the repo's native C++ runtime (``make -C native``).

The port loads the same ``native/libcoreth_native.so`` the reference
does, built from ``native/*.cc`` by the same Makefile target.  The
build is lazy and staleness-aware: a missing library is built, and one
older than any source (or the Makefile) is rebuilt.  Builds take an
exclusive file lock, so processes that start together (test workers,
a benchmark and its helpers) never run ``make`` over each other or
load a half-written library.
"""

from __future__ import annotations

import fcntl
import os
import subprocess
from typing import Optional

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(REPO_ROOT, "native")
LIB_NAME = "libcoreth_native.so"
# sources compiled only into the sanitizer builds: they never make the
# production library stale
_SANITIZER_ONLY = ("sanitize_smoke.cc", "tsan_smoke.cc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "csrc", "build")


def lib_path() -> str:
    return os.path.join(NATIVE_DIR, LIB_NAME)


def stale(path: str) -> bool:
    """True when the library is missing or older than a source."""
    try:
        lib_mtime = os.path.getmtime(path)
    except OSError:
        return True
    for fn in os.listdir(NATIVE_DIR):
        if fn in _SANITIZER_ONLY:
            continue
        if fn.endswith(".cc") or fn == "Makefile":
            if os.path.getmtime(os.path.join(NATIVE_DIR, fn)) > lib_mtime:
                return True
    return False


class BuildLock:
    """Exclusive lock on ``csrc/build/<name>.lock`` (held across a
    check-then-build so only one process builds)."""

    def __init__(self, name: str):
        os.makedirs(BUILD_DIR, exist_ok=True)
        self.path = os.path.join(BUILD_DIR, name + ".lock")

    def __enter__(self):
        self.fd = os.open(self.path, os.O_CREAT | os.O_RDWR, 0o644)
        fcntl.flock(self.fd, fcntl.LOCK_EX)
        return self

    def __exit__(self, *exc):
        fcntl.flock(self.fd, fcntl.LOCK_UN)
        os.close(self.fd)


def ensure_built(timeout: int = 300) -> Optional[str]:
    """The library path to load, building or rebuilding as needed.

    Returns None when there is no library and it cannot be built (no
    C++ toolchain).  A stale library whose rebuild fails is still
    returned: its symbols are what the sources had when it was built."""
    path = lib_path()
    with BuildLock("native"):
        if stale(path):
            try:
                subprocess.run(["make", "-C", NATIVE_DIR, LIB_NAME],
                               check=True, capture_output=True,
                               timeout=timeout)
            except (OSError, subprocess.SubprocessError):
                pass
    return path if os.path.exists(path) else None
