"""Build and load the port's native libraries at first use.

The libraries are compiled from sources in the checkout into
``dbgphmm_tpu_torch/build/`` (listed in ``.gitignore``) and loaded with
ctypes; nothing is built when a module is imported.

* ``libmapped_scorer_<hash>.so`` — the K1 and K2 scorers,
  ``csrc/mapped_scorer.cu``, compiled with ``nvcc`` for ``sm_90a``
  (Hopper).  It has a plain C interface: pointers and the CUDA stream
  travel as ``c_void_p``.
* ``libmapped_scorer_linear_<hash>.so`` — the K3 scorer,
  ``csrc/mapped_scorer_linear.cu``, built the same way.  Both CUDA sources
  include ``csrc/mapped_common.cuh``.
* ``lib<name>_<hash>.so`` — the host kernels in ``csrc/host/``, compiled
  with ``g++``: ``positions.cpp`` (slot positions, ``ops/sparse.py``),
  ``flow.cpp`` (the min-cost flow solver, ``flow/native.py``),
  ``seedchain.cpp`` (the seed chain DP, ``multi_dbg/seed.py``) and
  ``kshortest.cpp`` (Yen's k shortest paths, ``graph/k_shortest.py``).

The source hash in the file name keeps a stale build from being loaded
after an edit.  A failed build raises with the compiler's output; there is
no fallback here (the flow, seed and k-shortest loaders keep the pure-Python
fallbacks of the modules they were copied from).  :func:`build_all` runs
every compiler at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = PKG / "build"
SCORER_SRC = PKG / "csrc" / "mapped_scorer.cu"
LINEAR_SRC = PKG / "csrc" / "mapped_scorer_linear.cu"
COMMON_HDR = PKG / "csrc" / "mapped_common.cuh"
HOST_DIR = PKG / "csrc" / "host"
HOST_LIBS = ("positions", "flow", "seedchain", "kshortest")
HOST_FLAGS = ["-O3", "-shared", "-fPIC"]

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: dict = {}
BUILD_LOG: dict = {}  # library name -> {"seconds": float, "output": str}


def _tag(srcs, flags) -> str:
    h = hashlib.sha256()
    for src in srcs:
        h.update(src.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:12]


def _compile(cmd_of, srcs, stem: str, flags) -> Path:
    """Compile to ``build/<stem>_<hash>.so`` unless it exists; ``srcs`` are
    every file the build reads (sources and headers), hashed into the name.

    The compiler writes to a temporary name that is renamed into place, so
    concurrent test workers never load a half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"{stem}_{_tag(srcs, flags)}.so"
    if so.exists():
        BUILD_LOG.setdefault(stem, {"seconds": 0.0, "output": "(cached)"})
        return so
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd_of(tmp), capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"building {srcs[0].name} failed (rc={res.returncode}):\n"
                f"{res.stdout}\n{res.stderr}"
            )
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    BUILD_LOG[stem] = {"seconds": time.perf_counter() - t0,
                       "output": (res.stdout + res.stderr).strip()}
    return so


def nvcc_path() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA scorers need the CUDA "
                           "toolkit")
    return nvcc


def _cuda_lib(src: Path, stem: str, entries) -> ctypes.CDLL:
    """Build ``src`` with nvcc and bind ``entries``: {name: (restype,
    argtypes)}, plus ``dbg_cuda_error_string``."""
    nvcc = nvcc_path()
    so = _compile(lambda out: [nvcc, *NVCC_FLAGS, "-o", out, str(src)],
                  [src, COMMON_HDR], stem, NVCC_FLAGS)
    lib = ctypes.CDLL(str(so))
    entries = dict(entries, dbg_cuda_error_string=(ctypes.c_char_p,
                                                   [ctypes.c_int]))
    for name, (restype, argtypes) in entries.items():
        getattr(lib, name).restype = restype
        getattr(lib, name).argtypes = argtypes
    return lib


def mapped_scorer_lib() -> ctypes.CDLL:
    """The compiled K1 and K2 scorers (built on first call)."""
    if "scorer" not in _LIBS:
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        _LIBS["scorer"] = _cuda_lib(SCORER_SRC, "libmapped_scorer", {
            "dbg_mapped_scores_log": (i32, [vp] * 13 + [i32] * 10 + [vp]),
            "dbg_mapped_scores_log_single": (i32, [vp] * 13 + [i32] * 9 + [vp]),
            "dbg_mapped_scores_log_blocks_per_sm": (i32, [i32] * 6),
        })
    return _LIBS["scorer"]


def mapped_scorer_linear_lib() -> ctypes.CDLL:
    """The compiled K3 scorer (built on first call)."""
    if "linear" not in _LIBS:
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        _LIBS["linear"] = _cuda_lib(LINEAR_SRC, "libmapped_scorer_linear", {
            "dbg_mapped_scores_linear": (i32, [vp] * 12 + [i32] * 8 + [vp]),
            "dbg_mapped_scores_linear_smem": (ctypes.c_size_t, [i32] * 4),
        })
    return _LIBS["linear"]


def host_so(name: str) -> Path:
    """``csrc/host/<name>.cpp`` compiled with g++ (on first call)."""
    src = HOST_DIR / f"{name}.cpp"
    return _compile(lambda out: ["g++", *HOST_FLAGS, str(src), "-o", out],
                    [src], f"lib{name}", HOST_FLAGS)


def positions_lib() -> ctypes.CDLL:
    """The native slot-position builder (built on first call)."""
    if "positions" not in _LIBS:
        import numpy as np

        lib = ctypes.CDLL(str(host_so("positions")))
        lib.dbg_precompute_positions.restype = ctypes.c_int
        lib.dbg_precompute_positions.argtypes = [ctypes.c_int32] * 5 + [
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS"),
        ]
        _LIBS["positions"] = lib
    return _LIBS["positions"]


def build_all() -> None:
    """Build every native library at once, one compiler process each."""
    jobs = [mapped_scorer_lib, mapped_scorer_linear_lib]
    jobs += [lambda n=name: host_so(n) for name in HOST_LIBS]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        for f in [pool.submit(fn) for fn in jobs]:
            f.result()
