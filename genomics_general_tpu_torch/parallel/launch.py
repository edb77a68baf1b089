"""Local launch of a multi-process group: every rank a child process of
this one, on this host, with a hard deadline for the whole group.

When one rank exits non-zero or the deadline passes, every rank still
running is killed: a rank waiting at a rendezvous or a collective for a
peer that died would otherwise wait for ever.  Used by the multi-process
tests and by ``chip_smoke.py`` run S.
"""

from __future__ import annotations

import socket
import subprocess
import time
from pathlib import Path


def free_port() -> int:
    """A TCP port on 127.0.0.1 that is free now (for ``GGT_COORDINATOR``
    or ``MASTER_PORT``)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_group(argvs: list[list[str]], envs: list[dict], log_dir: Path,
              timeout: float, cwd=None) -> list[tuple[str, str]]:
    """Start every process ``argvs[k]`` (environment ``envs[k]``) at once
    and wait for all of them; their output goes to ``log_dir/p{k}.out``
    and ``.err``.  Returns each one's (stdout, stderr).  Raises
    RuntimeError, with the tail of every stderr, as soon as one exits
    non-zero or the group outlasts ``timeout`` seconds; every process still
    running is killed first."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    procs, files = [], []
    try:
        for k, (argv, env) in enumerate(zip(argvs, envs)):
            out = open(log_dir / f"p{k}.out", "w+b")
            err = open(log_dir / f"p{k}.err", "w+b")
            files.append((out, err))
            procs.append(subprocess.Popen(argv, env=env, cwd=cwd,
                                          stdout=out, stderr=err))
        deadline = time.monotonic() + timeout
        failed = None
        while failed is None:
            codes = [p.poll() for p in procs]
            bad = [k for k, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = f"process {bad[0]} exited {codes[bad[0]]}"
            elif all(c == 0 for c in codes):
                break
            elif time.monotonic() > deadline:
                failed = f"the group outlasted {timeout} s"
            else:
                time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate(timeout=60)
    got = []
    for out, err in files:
        out.seek(0)
        err.seek(0)
        got.append((out.read().decode(errors="replace"),
                    err.read().decode(errors="replace")))
        out.close()
        err.close()
    if failed:
        raise RuntimeError(failed + ":\n" + "\n---\n".join(
            e[-3000:] for _, e in got))
    return got
