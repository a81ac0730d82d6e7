"""Repository-level pytest hooks.

Builds the native host library (`make -C csrc`, csrc/build/libbn254_host.so)
once, in the controlling process, before any test module is imported and
before any xdist worker starts. `bn254_tpu/host/native.py` runs the same
`make` itself when the library is missing; left to the workers, each one
that imports a user of it starts its own build of the same file, and a
worker that loads the file while another build rewrites it gets no library
and skips tests/test_native_host.py. With the library built here first,
every worker finds it complete and loads it.

Where csrc/ cannot be written (a read-only checkout), the library is built
into a directory under the system's temporary directory instead, and every
process points `native._SO` at it. A missing compiler leaves the library
unbuilt, as before (its tests then skip).
"""

import hashlib
import os
import subprocess
import tempfile

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_SO = os.path.join(_CSRC, "build", "libbn254_host.so")
_ALT_DIR = os.path.join(
    tempfile.gettempdir(),
    "bn254_host_" + hashlib.sha256(_CSRC.encode()).hexdigest()[:16])
_ALT_SO = os.path.join(_ALT_DIR, "libbn254_host.so")


def _make(*args):
    try:
        subprocess.run(["make", "-C", _CSRC, *args], capture_output=True,
                       timeout=300, check=False)
    except (OSError, subprocess.TimeoutExpired):
        pass


def pytest_configure(config):
    if not hasattr(config, "workerinput"):  # not an xdist worker
        _make()
        if not os.path.exists(_SO):
            _make(f"BUILD={_ALT_DIR}")
    if not os.path.exists(_SO) and os.path.exists(_ALT_SO):
        from bn254_tpu.host import native

        native._SO = _ALT_SO
