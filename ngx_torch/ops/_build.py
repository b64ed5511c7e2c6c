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
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("train_rollout.cu", "rollout.cu", "native_reset.cu")
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
        [P, Ci, P, Ci]                           # tab, n_tab, dims, n_dims
        + [P, P, P, P, P, Ci]                    # state in, params, n_params
        + [Ci] * 9                               # seed .. n_items
        + [P] * 8                                # state and trajectory out
        + [P, P, P, Ci, P, P]                    # pool, R, base in / out
        + [Ci, P])                               # novelty, stream
    lib.ngx_train_rollout.restype = Ci
    # ngx_rollout: see csrc/rollout.cu
    lib.ngx_rollout.argtypes = (
        [P, Ci, P, P, Ci]                        # tab, n_tab, hdr, dims, n_dims
        + [P, P, Ci]                             # actions, params, n_params
        + [Ci] * 12                              # source .. n_items
        + [P] * 7                                # state, sums, packed out
        + [Ci, P])                               # novelty, stream
    lib.ngx_rollout.restype = Ci
    # ngx_tile_smem: a tile-MLP block's shared-memory bytes (negated where
    # they do not fit), ngx_rollout_smem a 'prng'/'input' block's, and
    # ngx_smem_optin the card's budget; ngx_wide_cell: the map cell's width
    lib.ngx_tile_smem.argtypes = [Ci, P, Ci, Ci, Ci, Ci, Ci]
    lib.ngx_tile_smem.restype = Ci
    lib.ngx_rollout_smem.argtypes = [Ci] * 5 + [P]
    lib.ngx_rollout_smem.restype = Ci
    lib.ngx_smem_optin.argtypes = []
    lib.ngx_smem_optin.restype = Ci
    # ngx_rollout_geometry: the last 'prng'/'input' launch's geometry (5
    # ints out; 0 where the last call launched none)
    lib.ngx_rollout_geometry.argtypes = [P]
    lib.ngx_rollout_geometry.restype = Ci
    lib.ngx_wide_cell.argtypes = [Ci]
    lib.ngx_wide_cell.restype = Ci
    lib.ngx_error_string.argtypes = [Ci]
    lib.ngx_error_string.restype = ctypes.c_char_p
    return lib


def declare_native_reset(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare ``ngx_native_reset`` (csrc/native_reset.cu), apart from
    :func:`declare`: the host builds of the other kernels' device code
    hold no such entry, nor a host build of this one theirs."""
    P, Ci = ctypes.c_void_p, ctypes.c_int
    lib.ngx_native_reset.argtypes = (
        [P, Ci, Ci, Ci]                          # tab, n, hw, n_items
        + [P, P, ctypes.c_longlong, P]           # keys, parent, offset, done
        + [P, P, P])                             # state in, out, stream
    lib.ngx_native_reset.restype = Ci
    return lib


def sass_counts(lib: Path) -> dict:
    """``{mangled kernel name: (instructions, BSSY)}`` for every kernel in
    the built library ``lib``, from ``cuobjdump -sass``: its SASS
    instructions, less the ``NOP``s that pad a function's end, and among
    them its reconvergence points (``BSSY``).  Only on a machine with the
    CUDA toolkit."""
    text = subprocess.run(
        [str(Path(find_nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
        capture_output=True, text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            counts[name] = [0, 0]
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", line):
            op = line.split("*/", 1)[1].strip().split(" ;")[0]
            if op.startswith("NOP"):
                continue
            counts[name][0] += 1
            counts[name][1] += "BSSY" in op.split()[:2]
    return {n: tuple(c) for n, c in counts.items()}


def demangle(names) -> list:
    """The names demangled by the toolkit's ``cu++filt``, or as they are
    where it is missing."""
    names = list(names)
    filt = Path(find_nvcc()).parent / "cu++filt"
    if filt.is_file() and names:
        out = subprocess.run([str(filt)], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(names):
            return out.stdout.splitlines()
    return names


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built library with its C functions' signatures declared, loaded
    once per process: the sources are hashed at the first call only, not on
    every launch."""
    return declare_native_reset(declare(ctypes.CDLL(str(build()[0]))))
