"""Build and bind the port's CUDA kernels (kernels/csrc/*.cu).

``nvcc`` compiles each source into a shared library with a plain C
interface, for ``sm_90a`` only, into the gitignored ``build/`` directory
(content-keyed, _buildcache); ``ctypes`` binds it.  Nothing builds at
import: the first CUDA launch builds, so CPU-only machines never need
``nvcc``.  Each C entry point returns ``cudaGetLastError()`` after its
launch; :func:`check` turns a non-zero code into an exception.  A wrapper
keeps each entry point as an :class:`Entry`, resolved on its first call.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import threading
from pathlib import Path

from .._buildcache import cached_build

_CSRC = Path(__file__).resolve().parent / "csrc"
_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_L = ctypes.c_longlong

# C signatures: every pointer and the stream as void*, sizes as int (row
# strides and span lengths as long long), reals as double
_SIGNATURES = {
    "pair_v3": {
        "ggt_pair_counts_v3": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
        "ggt_pair_counts_v2": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
        "ggt_exception_patch": [_P, _P, _P, _I, _I, _I, _P, _P, _P],
        "ggt_blocks_tail": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                            _P],
        "ggt_tri_pack": [_P, _P, _I, _I, _I, _P, _P],
        "ggt_het_pairs": [_P, _P, _P, _P, _I, _I, _I, _P, _P],
    },
    "counts": {
        "ggt_site_pop_counts": [_P, _I, _I, _I, _I, _P, _P, _I, _I, _I, _P,
                                _P],
        "ggt_site_pop_counts_raw": [_P, _L, _I, _I, _P, _P, _I, _I, _I, _P,
                                    _P],
        "ggt_global_sfs_hist": [_P, _I, _I, _I, _P, _L, _P, _P],
        "ggt_stacked_reduce": [_P, _I, _I, _L, _I, _P, _P],
        "ggt_site_nonmissing": [_P, _L, _I, _P, _P, _I, _P, _I, _I, _P,
                                _P],
        "ggt_sample_base_counts": [_P, _L, _I, _I, _P, _P],
    },
    "abba": {
        "ggt_abba_site_terms": [_P, _I, _I, _I, _P, _P, _D, _D, _D, _D, _D,
                                _I, _I, _P, _P],
        "ggt_abba_window_sums": [_P, _I, _I, _P, _P, _I, _I, _P, _P],
    },
    "pair4": {
        "ggt_pair_counts_4state": [_P, _L, _L, _P, _P, _I, _I, _I, _I, _P,
                                   _P, _P],
        "ggt_pair_counts_4state_rows": [_P, _L, _L, _P, _P, _I, _I, _I, _I,
                                        _I, _I, _P, _P, _P],
        "ggt_flush_pair_counts": [_P, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    },
    "ld": {
        "ggt_pair_allele_tables": [_P, _L, _I, _I, _P, _P, _P],
    },
    "window_stats": {
        "ggt_window_stats_tail": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                                  _P, _P, _P, _P],
        "ggt_window_pop_counts": [_P, _L, _L, _P, _P, _P, _P, _I, _I, _I,
                                  _I, _I, _P, _P],
    },
}
# nvcc flags of one source beyond the common line: abba.cu's f4 terms must
# equal numpy's bit for bit, and window_stats.cu's float32 Fst its plain
# version's, so no multiply-add is contracted into an fma
_EXTRA_FLAGS = {"abba": ["--fmad=false"], "window_stats": ["--fmad=false"]}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _command(src: Path, extra: list[str]):
    def cmd(out: Path) -> list[str]:
        return [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-Xptxas", "-v", *extra, "-shared",
                "-Xcompiler", "-fPIC",
                "-o", str(out), str(src)]
    return cmd


def build(name: str) -> Path:
    """Compile ``csrc/{name}.cu`` (cached, keyed on it and the shared
    ``csrc/*.cuh`` headers) and return the library path; ``nvcc``'s
    register and spill report is beside it with ``.log``."""
    src = _CSRC / f"{name}.cu"
    try:
        return cached_build(name, [src, *sorted(_CSRC.glob("*.cuh"))],
                            _command(src, _EXTRA_FLAGS.get(name, [])))
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"nvcc failed on {src}:\n{e.stdout}{e.stderr}") \
            from e


def lib(name: str) -> ctypes.CDLL:
    """The bound library of ``csrc/{name}.cu``, built on first use (the
    lock is taken only then)."""
    cdll = _libs.get(name)
    if cdll is not None:
        return cdll
    with _lock:
        if name not in _libs:
            cdll = ctypes.CDLL(str(build(name)))
            for fn, argtypes in _SIGNATURES[name].items():
                f = getattr(cdll, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = cdll
        return _libs[name]


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {code}")


class Entry:
    """The C entry point ``fn`` of ``csrc/{lib_name}.cu`` as a callable
    that launches and raises (:func:`check`) on a CUDA error code.  The
    library is built, loaded and typed on the first call, never at import
    or on a CPU tensor's path; later calls read the kept ctypes function
    and call it."""

    __slots__ = ("lib_name", "fn_name", "what", "fn")

    def __init__(self, lib_name: str, fn_name: str):
        if fn_name not in _SIGNATURES[lib_name]:
            raise KeyError(f"{lib_name}.cu has no entry point {fn_name}")
        self.lib_name, self.fn_name = lib_name, fn_name
        self.what = fn_name.removeprefix("ggt_")
        self.fn = None

    def __call__(self, *args) -> None:
        fn = self.fn
        if fn is None:
            fn = self.fn = getattr(lib(self.lib_name), self.fn_name)
        code = fn(*args)
        if code:
            check(code, self.what)
