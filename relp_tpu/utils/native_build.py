"""Build the native C++ helpers (``native/*.cpp``) at first use.

The shared libraries are never committed: a library built on one host may
not load on another.  :func:`native_library` runs ``make -C native <lib>``
when the library is missing or older than its source, and returns None when
it cannot be built (no source or no ``make``), so callers keep their
pure-Python paths.
"""

from __future__ import annotations

import fcntl
import os
import shutil
import subprocess
import sys
from typing import Optional

NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)


def _fresh(lib: str, src: str) -> bool:
    return os.path.exists(lib) and (
        not os.path.exists(src) or os.path.getmtime(lib) >= os.path.getmtime(src)
    )


def native_library(name: str, directory: str = NATIVE_DIR) -> Optional[str]:
    """Path of ``directory/name`` (e.g. ``libmodp.so``), built from
    ``directory/<stem>.cpp`` if needed; None when unavailable."""
    lib = os.path.join(directory, name)
    src = os.path.join(directory, name[len("lib"):-len(".so")] + ".cpp")
    if _fresh(lib, src):
        return lib
    if not os.path.exists(src) or shutil.which("make") is None:
        return lib if os.path.exists(lib) else None
    # Several processes (test workers) may ask at once: one builds, the
    # others wait on the lock and then find the library fresh.
    with open(os.path.join(directory, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _fresh(lib, src):
            print(f"building {name} from {src}", file=sys.stderr, flush=True)
            proc = subprocess.run(
                ["make", "-C", directory, name], capture_output=True, text=True
            )
            if proc.returncode != 0:
                print(proc.stderr, file=sys.stderr, flush=True)
    return lib if _fresh(lib, src) else None
