"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under ``pairing_tpu_torch/csrc/`` compiles to an object file,
all of them in parallel (one nvcc process per source, started together),
and the objects link into one shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -Xptxas -v -c -o <name>.o csrc/<name>.cu   # each
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \\
         -o libpairing_kernels.so *.o

Every device routine is ``static`` to its translation unit, so no device
linking is needed. The build runs at first use, into ``build/pairing_tpu_torch/<hash>/`` at
the root of the checkout (git-ignored), keyed by a hash of the sources and
flags, so an unchanged tree reuses its library. ptxas's register and spill
report is kept beside the library in ``ptxas.log``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import time
from functools import lru_cache
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "pairing_tpu_torch"
LIB_NAME = "libpairing_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C entry points: name -> argument types. Each returns cudaGetLastError().
ENTRY_POINTS = {
    "pt_fq12_mul": (_P, _P, _I, _P, _I, _P),
    "pt_fq12_sq": (_P, _P, _I, _P),
    "pt_fq12_cyc_sq": (_P, _P, _I, _P),
    "pt_miller_f": (_P, _P, _P, _P, _I, _I, _P, _P, _I, _P),
    "pt_pow_ladder_stream": (_P, _P, _I, _P, _I, _P),
    "pt_fq12_slotwise": (_P, _P, _P, _P, _I, _P),
    "pt_fp_pow_bits": (_P, _P, _I, _I, _P, _I, _P),
    "pt_fq2_inv": (_P, _P, _I, _P),
    "pt_fq12_inv": (_P, _P, _P, _I, _P),
    "pt_trajectory": (_P, _P, _I, _P, _P, _P, _I, _P),
    "pt_prefix_products": (_P, _I, _P, _P, _I, _P),
    "pt_running_inverse": (_P, _P, _P, _I, _P, _I, _P),
    "pt_lines": (_P, _P, _P, _P, _P, _I, _I, _P, _P, _I, _P),
    "pt_exp_bits": (_P, _P, _I, _P, _I, _P),
    "pt_affine_export": (_P, _I, _P, _I, _P, _I, _P),
    "pt_pow_ladder": (_P, _P, _P, _I, _P, _I, _P),
    "pt_pow_ladder_w4": (_P, _P, _I, _P, _I, _P, _I, _P),
    "pt_hard_chain": (_P, _P, _P, _P, _P, _I, _P, _P, _I, _P, _I, _P),
    "pt_epilogue_points": (_P, _P, _P, _P, _P, _I, _P),
    "pt_epilogue_lines": (_P, _P, _P, _P, _P, _P, _P, _I, _P),
    "pt_canonical": (_P, _I, _P, _P, _I, _P),
    "pt_validate": (_P, _I, _P, _I, _P),
}


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float  # nvcc wall time; 0.0 when an earlier build was reused
    ptxas: str  # nvcc's -Xptxas -v report


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def build() -> BuildInfo:
    """Compile the kernels unless a library for these sources exists."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    log_path = out_dir / "ptxas.log"
    if lib_path.is_file():
        log = log_path.read_text() if log_path.is_file() else ""
        return BuildInfo(lib_path, 0.0, log)
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    units = [s for s in sources() if s.suffix == ".cu"]
    objs = [out_dir / f"{s.stem}.{tag}.o" for s in units]
    log_files = [o.with_suffix(".log") for o in objs]
    procs = []
    for src, obj, log in zip(units, objs, log_files):
        with open(log, "w") as fh:  # a file, not a pipe: no process blocks on output
            procs.append(subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                          cwd=CSRC, stdout=fh, stderr=subprocess.STDOUT))
    for p in procs:
        p.wait()
    logs = [f.read_text() for f in log_files]
    failed = [(s.name, p.returncode, log) for s, p, log in zip(units, procs, logs)
              if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{name} ({rc}):\n{log}" for name, rc, log in failed))
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True, cwd=CSRC)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}\n{link.stderr}")
    seconds = time.perf_counter() - t0
    for f in objs + log_files:
        f.unlink()
    log = "".join(logs)
    log_path.write_text(log)
    os.replace(tmp, lib_path)
    return BuildInfo(lib_path, seconds, log)


def sass(path) -> dict:
    """SASS text per function in ``cuobjdump -sass`` of an object or library."""
    cuobjdump = Path(_nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "-sass", str(path)], capture_output=True, text=True,
                         check=True).stdout
    return {part.split("\n", 1)[0].strip(): part for part in out.split("Function : ")[1:]}


def sass_count(text: str) -> int:
    """Instructions in one function's SASS text."""
    return len(re.findall(r"^\s+/\*[0-9a-f]{4,}\*/", text, re.M))


@lru_cache(maxsize=None)
def load() -> tuple:
    """Build if needed, load the library, declare its entry points.
    Returns (ctypes.CDLL, BuildInfo)."""
    info = build()
    lib = ctypes.CDLL(str(info.path))
    for name, argtypes in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.pt_error_string.argtypes = [ctypes.c_int]
    lib.pt_error_string.restype = ctypes.c_char_p
    for name in ("pt_trajectory_shared_bytes", "pt_exp_bits_shared_bytes",
                 "pt_fq12_inv_shared_bytes", "pt_pow_ladder_shared_bytes",
                 "pt_pow_ladder_w4_shared_bytes", "pt_hard_chain_shared_bytes"):
        fn = getattr(lib, name)  # dynamic shared bytes a block asks for at launch
        fn.argtypes = []
        fn.restype = ctypes.c_int
    return lib, info
