"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The kernels are compiled with ``nvcc`` for ``sm_90a`` and linked into one
shared library with a plain C interface, loaded with ctypes.  The build
happens at the first CUDA use, from the package's own sources, into
``blasted_tpu_torch/build/`` (git-ignored): one ``nvcc -c`` per ``.cu`` file,
all started together, then one link.  The library's file name carries a hash
of every source (``.cu`` and ``.cuh``) and of the flags, so an edited source
is rebuilt and an unchanged one is loaded as it is.  ``ptxas`` reports each
kernel's registers and spills; the report is kept beside the library as
``ptxas_<hash>.log``.  Nothing here runs at import time.

Every wrapper launches through :func:`launch`, which counts launches per
kernel in :data:`launches` and per kernel and card in
:data:`launches_by_device`, so a run can show that its path went through
the kernels, and on which card, and sums the host nanoseconds each launch
took in :data:`launch_ns` (always on: two ``perf_counter_ns`` reads and an
add; the wrappers' operand checks before the call are not in it).
``launch`` takes the device of the call's operands and refuses it unless
it is the current CUDA device: a kernel launched from another card would
read the operands over NVLink and still compute the right numbers, so only
this check can see such a launch.
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

import torch

__all__ = ["kernels_library", "NVCC_FLAGS", "KERNEL_SOURCES", "launches",
           "launches_by_device", "launch_ns", "reset_launches", "launch"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_OFFS = ctypes.POINTER(ctypes.c_longlong)
_IDX = ctypes.POINTER(ctypes.c_int)

# argtypes of each C entry point (csrc/*.cu); every one returns a
# cudaError_t as int
_SIGNATURES = {
    "bt_dia_spmv": (_OFFS, _I32, _I32, _P, _P, _P, _I64, _P),
    "bt_tri_sweep": (_OFFS, _I32, _I32, _P, _P, _P, _P, _P, _I64, _P),
    "bt_zero_start_sweep": (_OFFS, _I32, _I32, _I32, _P, _P, _P, _P, _I64,
                            _P),
    "bt_factor_u0": (_OFFS, _I32, _I32, _P, _P, _P, _P, _P, _I64, _P),
    "bt_factor_lower": (_OFFS, _I32, _I32, _P, _P, _P, _I64, _P),
    "bt_bdia_spmv": (_OFFS, _I32, _I32, _I32, _P, _P, _P, _I64, _P),
    "bt_bdia_factor": (_OFFS, _I32, _I32, _I32, _I32, _P, _P, _P, _P, _P,
                       _I64, _P),
    "bt_bdia_block_inverse": (_I32, _I32, _P, _P, _P, _I64, _P),
    "bt_bdia_sweep": (_IDX, _OFFS, _I32, _I32, _I32, _I32, _P, _P, _P, _P,
                      _P, _I64, _P),
    "bt_bdia_head_sweep": (_IDX, _OFFS, _I32, _I32, _I32, _I32, _P, _P, _P,
                           _P, _I64, _P),
    "bt_plain_factor_sweep": (_OFFS, _I32, _I32, _I32, _P, _P, _P, _P, _P,
                              _I64, _P),
    "bt_padded_mv": (_I32, _I32, _I32, _P, _P, _P, _P, _P, _P, _I64, _I32,
                     _P),
    "bt_padded_factor_sweep": (_I32, _I32, _P, _P, _P, _P, _P, _P, _P, _P,
                               _I64, _P),
}

#: The source under ``csrc/`` of each kernel, by the name its launches are
#: counted under (K6 by mode: the Dinv-emitting sweeps and the U0-emitting
#: final sweep; K7, K10, the zero-start sweep K12 and the block head sweep
#: K13 by mode: the unit-lower and the upper apply sweep; K9-K11 are the
#: padded path's).
KERNEL_SOURCES = {
    "dia_spmv": "dia_stencil.cu", "tri_sweep": "dia_stencil.cu",
    "zero_start_lower_sweep": "dia_stencil.cu",
    "zero_start_upper_sweep": "dia_stencil.cu",
    "factor_u0": "dia_stencil.cu", "factor_lower": "dia_stencil.cu",
    "bspmv": "bdia_stencil.cu", "bfactor_dinv": "bdia_stencil.cu",
    "bfactor_u0": "bdia_stencil.cu", "block_inverse": "bdia_stencil.cu",
    "bdia_lower_sweep": "bdia_stencil.cu",
    "bdia_upper_sweep": "bdia_stencil.cu",
    "bdia_head_lower_sweep": "bdia_stencil.cu",
    "bdia_head_upper_sweep": "bdia_stencil.cu",
    "plain_factor_sweep": "dia_stencil.cu",
    "padded_spmv": "padded.cu", "padded_lower_sweep": "padded.cu",
    "padded_upper_sweep": "padded.cu", "padded_factor_sweep": "padded.cu",
}

#: Kernel launches since the last :func:`reset_launches`, by kernel.
launches = dict.fromkeys(KERNEL_SOURCES, 0)
#: The same launches by kernel, then by the index of the CUDA device each
#: ran on (``launches_by_device[name][index]``; a card with none is absent).
launches_by_device = {name: {} for name in KERNEL_SOURCES}
#: Host nanoseconds in :func:`launch` since the last :func:`reset_launches`,
#: by kernel, from the device check to the return (the library's build at
#: its first use left out).
launch_ns = dict.fromkeys(KERNEL_SOURCES, 0)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
        launches_by_device[name].clear()
        launch_ns[name] = 0


def launch(name: str, entry: str, device: torch.device, *args) -> None:
    """Call the C entry point ``entry`` with ``args`` on the current CUDA
    stream and count one launch of kernel ``name`` on that card.
    ``device`` is the device of the call's operands; it must be the
    current CUDA device (the wrappers set it), else this raises before
    launching.  A CUDA error raises."""
    fn = getattr(kernels_library(), entry)   # built at the first use
    t0 = time.perf_counter_ns()
    current = torch.cuda.current_device()
    if device.type != "cuda" or device.index != current:
        raise RuntimeError(f"{name}: operands on {device}, but the current "
                           f"CUDA device is cuda:{current}")
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    launches[name] += 1
    by_card = launches_by_device[name]
    by_card[current] = by_card.get(current, 0) + 1
    launch_ns[name] += time.perf_counter_ns() - t0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found is not None:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"                     # the toolkit's default home
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or in CUDA_HOME: the CUDA "
                       "kernels of blasted_tpu_torch are built with the "
                       "CUDA toolkit at first CUDA use")


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted([*_CSRC.glob("*.cu"), *_CSRC.glob("*.cuh")]):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()[:16]


def _build(target: Path, log: Path) -> None:
    nvcc = _nvcc()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        reports = []
        for cmd, proc in procs:
            out, _ = proc.communicate()
            reports.append(f"$ {' '.join(cmd)}\n{out}")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{reports[-1]}")
        lib = Path(tmp) / target.name
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
               "-o", str(lib), *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        log.write_text("\n".join(reports))
        os.replace(lib, target)      # atomic: concurrent builds are safe


@functools.lru_cache(maxsize=1)
def kernels_library() -> ctypes.CDLL:
    """The loaded kernel library, built first if a source changed."""
    digest = _digest()
    target = _BUILD_DIR / f"libbt_kernels_{digest}.so"
    if not target.exists():
        _build(target, _BUILD_DIR / f"ptxas_{digest}.log")
    lib = ctypes.CDLL(str(target))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
