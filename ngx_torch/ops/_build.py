"""Build and load the port's CUDA kernels: ``nvcc`` into a shared library with
a plain C interface, loaded with ``ctypes``.

The library is built at first use from the sources under ``csrc/`` (one
``nvcc`` for each source, all started together, then one link) into
``build/ngx_torch/`` at the root of the checkout, under a name keyed on a
hash of the flags and of every file under ``csrc/``, the shared header
included, so a changed source or header builds anew and an unchanged tree
loads the library already built.  Nothing is built or loaded at import
time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("train_rollout.cu", "rollout.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ngx_torch"
# sm_90a: the Hopper target (wgmma and setmaxnreg exist only there); no
# -use_fast_math, so logf, tanhf, the float32 adds and the float64
# ceil-percent stay IEEE
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def library_path(csrc: Path = CSRC) -> Path:
    """The library's path, keyed on the flags and every file under
    ``csrc`` (names and bytes)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(p for p in csrc.rglob("*") if p.is_file()):
        h.update(path.relative_to(csrc).as_posix().encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"libngx_torch_{h.hexdigest()[:16]}.so"


def build() -> tuple:
    """Compile the library if it is not built yet.  Returns ``(path,
    seconds, compiler output)``; seconds is 0.0 when nothing was built."""
    out = library_path()
    if out.is_file():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = find_nvcc()
    log = []
    # build in a temporary directory, then rename: a half-written library is
    # never loaded
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, Path(s).stem + ".o") for s in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o,
                                   str(CSRC / s)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(SOURCES, objs)]
        for s, proc in zip(SOURCES, procs):
            text = proc.communicate()[0]
            log.append(text)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s} ({proc.returncode}):"
                                   f"\n{text}")
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc, "-shared", "-o", lib, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"linking the kernels failed ({proc.returncode})"
                               f":\n{proc.stdout}{proc.stderr}")
        os.replace(lib, out)
    return out, time.perf_counter() - t0, "".join(log)


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the signatures of the library's C functions (the CUDA build's
    or a host build's of the same device code)."""
    P, Ci = ctypes.c_void_p, ctypes.c_int
    # ngx_train_rollout: see csrc/train_rollout.cu for the argument list
    lib.ngx_train_rollout.argtypes = (
        [P, Ci, P, P, P, P, P, Ci]              # tab .. n_params
        + [Ci] * 8                               # seed .. n_items
        + [P, Ci]                                # scratch, maxw
        + [P] * 8                                # state and trajectory out
        + [P, P, P, Ci, P, P]                    # pool, R, base in / out
        + [Ci, P])                               # novelty, stream
    lib.ngx_train_rollout.restype = Ci
    # ngx_rollout: see csrc/rollout.cu
    lib.ngx_rollout.argtypes = (
        [P, Ci, P, P, Ci]                        # tab .. n_params
        + [Ci] * 8                               # source .. n_items
        + [P, Ci]                                # scratch, maxw
        + [P] * 6                                # state and sums out
        + [Ci, P])                               # novelty, stream
    lib.ngx_rollout.restype = Ci
    lib.ngx_error_string.argtypes = [Ci]
    lib.ngx_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built library with its C functions' signatures declared, loaded
    once per process: the sources are hashed at the first call only, not on
    every launch."""
    return declare(ctypes.CDLL(str(build()[0])))
