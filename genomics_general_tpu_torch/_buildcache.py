"""Content-keyed build cache for the port's native libraries.

Every shared library the port loads (the host C tokenizer, the CUDA
kernels) is compiled from sources in the checkout into ``build/`` at the
repository root (gitignored), named by a hash of its sources and compile
command, so a stale library is never loaded.  Concurrent processes (test
workers, CLI subprocesses) serialize on a lock file and install the result
with an atomic rename, so no process ever loads a half-written file.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent.parent / "build"


def cached_build(name: str, sources: list[Path], command, timeout: int = 600) -> Path:
    """Return the path of ``build/{name}-{hash}.so``, building it first if
    it is missing; the compiler's messages go to the same name with
    ``.log``.  ``command(out_path) -> argv`` gives the compile command; a
    non-zero exit raises ``subprocess.CalledProcessError`` with the
    compiler's output attached."""
    h = hashlib.sha256()
    for src in sources:
        h.update(src.read_bytes())
    h.update(" ".join(command(Path("OUT"))).encode())
    out = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f".{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            tmp = out.with_suffix(f".tmp{os.getpid()}")
            try:
                r = subprocess.run(command(tmp), check=True,
                                   capture_output=True, text=True,
                                   timeout=timeout)
                out.with_suffix(".log").write_text(r.stdout + r.stderr)
                os.replace(tmp, out)
            finally:
                tmp.unlink(missing_ok=True)
    return out
