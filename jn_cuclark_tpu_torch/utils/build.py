"""Build shared libraries from the repository's sources at first use.

The port ships sources only: the native host runtime (`native/clark_native.cpp`
and the port's `native/record_cut.cpp`) and the CUDA kernels
(`ops/kernels/classify.cu`) are compiled into
`jn_cuclark_tpu_torch/_build/` the first time a process needs them.  A build
is keyed by a hash of its sources and its command line, so an edited source
rebuilds and an unchanged one is reused.

Several processes may reach the same build at once (pytest-xdist workers,
concurrent CLI runs), so a build holds an exclusive file lock, compiles into
a private temporary path and publishes the result with `os.replace`.  A
failed build raises with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess

BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build"
)
REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


class BuildError(RuntimeError):
    """A compiler run failed; the message carries its output."""


def build_library(name: str, sources: list[str], command) -> str:
    """Path of the shared library `name` built from `sources`.

    `command(out_path)` returns the compiler's argv writing `out_path`."""
    h = hashlib.sha256()
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update("\0".join(command("OUT")).encode())
    out = os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):  # built by another process while we waited
            return out
        tmp = f"{out}.{os.getpid()}.tmp"
        argv = command(tmp)
        try:
            proc = subprocess.run(argv, capture_output=True, text=True)
        except OSError as e:
            raise BuildError(f"cannot run {argv[0]}: {e}") from e
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise BuildError(
                f"building {name} failed (exit {proc.returncode}):\n"
                f"$ {' '.join(argv)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    return out
