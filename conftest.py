"""Set-up shared by the whole test suite.

The JAX package's C++ loader (`pwn_tpu/data/native_loader.py`) compiles
`native/loader.cc` in place at first use, and its tests ask for it while
their module is imported (`tests/test_native_loader.py`'s skip condition).
Under pytest-xdist every worker imports every test module at about the same
time, so on a checkout without `native/build/` several workers compile the
library at once into the same path, and a worker that loads a half-written
file skips that module's tests ("g++ toolchain unavailable"): six processes
started together reproduce it, one in six seeing no loader.  Here the
controlling process builds the library once, under a file lock, before any
worker starts; the workers then find it whole and up to date.  Where it
cannot be built (no g++), nothing changes: those tests skip as before.
"""

import fcntl
import subprocess
from pathlib import Path


def pytest_configure(config):
    if hasattr(config, "workerinput"):   # an xdist worker: already built
        return
    build = Path(__file__).resolve().parent / "native" / "build"
    try:
        build.mkdir(parents=True, exist_ok=True)
        with open(build / ".build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            from pwn_tpu.data.native_loader import build_native

            build_native()
    except (ImportError, OSError, subprocess.CalledProcessError):
        pass   # no toolchain: the loader's tests skip themselves, as before
