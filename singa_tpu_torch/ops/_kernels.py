"""Build and bind the port's hand-written CUDA kernels.

Each `singa_tpu_torch/csrc/<name>.cu` is a plain C interface compiled by
`nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC` into `build/kernels/` at the root of the checkout (a
git-ignored directory), at first use, and loaded with `ctypes`.  The
library name carries a hash of the source, the shared headers
(`csrc/*.cuh`) and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  `build()`
starts one nvcc per source, all at once.

Nothing here runs when the module is imported: the CPU tests import
every module of the package, and this machine may have no nvcc at all.

Each C entry takes every pointer and the stream as `void*`, its sizes as
`int` and its real parameters as `double`, and returns
`cudaGetLastError()` after the launch; `launch` raises when that is not
0 and otherwise adds one to the kernel's count in `LAUNCHES`, the count
a run reads to show that its path went through the kernel.  Launches
on a stream inside `recording(stream)` (a CUDA-graph capture and its
warm-up, whichever thread launches: the autograd engine runs a
backward on a thread of its own) count into a dict of their own
instead, so a capture neither counts itself nor touches what other
threads count meanwhile.

Beside the kernels, `csrc/zstd_dec.cu` is host code with a plain C
interface (the native decoder of the zstd frames and CRC32C of the
JAX package's orbax checkpoints, `utils/zstd.py`), built by the same
nvcc command and bound the same way.  `host_call` calls one of its
functions: no stream, no launch; it raises `HostCallError` when the
function returns an error code and otherwise adds one to the
function's count in `CALLS`.  ctypes releases the GIL for the call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_L = ctypes.c_longlong
# kernel name -> argtypes of its C entry (same name), stream last
SIGNATURES = {
    # q, k, v, o, lse, B, Sq, Sk, H, Hkv, D, causal, qscale, dtype, stream
    # (qscale: attention.fold_constant, the scale*log2e that q is
    # multiplied by in q's dtype)
    "flash_fwd": [_P] * 5 + [_I] * 7 + [_D, _I, _P],
    # h, w, labels, lse, ll, hit, ws, N, E, V, split_tiles, dtype, stream
    "head_fwd": [_P] * 7 + [_I] * 5 + [_P],
    # q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, Hkv, D, causal,
    # qscale, dtype, stream
    "flash_dq": [_P] * 7 + [_I] * 7 + [_D, _I, _P],
    # q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, Hkv, D, causal,
    # qscale, dtype, stream
    "flash_dkv": [_P] * 8 + [_I] * 7 + [_D, _I, _P],
    # x, y, P, C, local_size, alpha, beta, knorm, relu, dtype, stream
    "lrn_fwd": [_P] * 2 + [_I] * 3 + [_D] * 3 + [_I] * 2 + [_P],
    # x, g, dx, P, C, local_size, alpha, beta, knorm, relu, dtype, stream
    "lrn_bwd": [_P] * 3 + [_I] * 3 + [_D] * 3 + [_I] * 2 + [_P],
}
# host library (csrc/<name>.cu) -> its C functions -> their argtypes;
# each returns 0 or an error code that `<library>_error_string` names
HOST_SIGNATURES = {
    "zstd_dec": {
        # src, n, dst, capacity, written (long long*)
        "zstd_dec": [_P, _L, _P, _L, _P],
        # src, n, crc (uint32*)
        "zstd_dec_crc32c": [_P, _L, _P],
    },
}
LAUNCHES: Dict[str, int] = {name: 0 for name in SIGNATURES}
CALLS: Dict[str, int] = {fn: 0 for fns in HOST_SIGNATURES.values()
                         for fn in fns}
_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[tuple, tuple] = {}
_lock = threading.Lock()
_counts_lock = threading.Lock()
# stream handle -> the launch counts of a capture recording on it
_recording: Dict[int, Dict[str, int]] = {}


class HostCallError(RuntimeError):
    """A host library function returned an error code (`code`)."""

    def __init__(self, message: str, code: int):
        super().__init__(message)
        self.code = code


def reset_launches() -> None:
    with _counts_lock:
        for counts in (LAUNCHES, CALLS):
            for name in counts:
                counts[name] = 0


def add_launches(counts: Dict[str, int],
                 stream: Optional[int] = None) -> None:
    """Add `counts` (kernel -> launches) to `LAUNCHES`, or, for launches
    on `stream` (a handle) while it is recording, to its recording."""
    with _counts_lock:
        target = _recording.get(stream, LAUNCHES)
        for name, n in counts.items():
            target[name] = target.get(name, 0) + n


@contextmanager
def recording(stream):
    """Count the launches made on `stream` until the block ends, from
    any thread, into the yielded dict instead of `LAUNCHES`: a capture's
    launches are added at every replay instead."""
    rec: Dict[str, int] = {}
    with _counts_lock:
        _recording[stream.cuda_stream] = rec
    try:
        yield rec
    finally:
        with _counts_lock:
            _recording.pop(stream.cuda_stream, None)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    for cand in ((os.path.join(CUDA_HOME, "bin", "nvcc")
                  if CUDA_HOME else None), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's kernels are built from "
                       "singa_tpu_torch/csrc with the CUDA toolkit")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named kernels and host libraries (all by default) that
    are not built yet, one nvcc process per source, started together.
    Returns nvcc's output (ptxas register and spill lines) for each
    source built now."""
    jobs = {}
    for name in (list(names) if names is not None
                 else [*SIGNATURES, *HOST_SIGNATURES]):
        out = _target(name)
        if out.exists():
            continue
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    logs = {}
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)
        logs[name] = log
    return logs


def _bind(lib_name: str, fn_name: str, argtypes):
    """(C function, error-string function) of library `lib_name`, built
    and loaded at first use."""
    with _lock:
        got = _entries.get((lib_name, fn_name))
        if got is None:
            lib = _libs.get(lib_name)
            if lib is None:
                build([lib_name])
                lib = _libs[lib_name] = ctypes.CDLL(str(_target(lib_name)))
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            err = getattr(lib, f"{lib_name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            got = _entries[(lib_name, fn_name)] = (fn, err)
    return got


def _entry(name: str):
    return _bind(name, name, SIGNATURES[name])


def launch(name: str, *args) -> None:
    """Launch kernel `name` on the current stream without synchronising;
    raise on a refused launch, else count it."""
    fn, err_string = _entry(name)
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} "
                           f"({err_string(err).decode()})")
    add_launches({name: 1}, stream)


def host_call(lib: str, fn: str, *args) -> None:
    """Call host function `fn` of library `lib`; raise `HostCallError`
    on an error code, else count the call."""
    f, err_string = _bind(lib, fn, HOST_SIGNATURES[lib][fn])
    err = f(*args)
    if err != 0:
        raise HostCallError(f"{fn}: error {err} "
                            f"({err_string(err).decode()})", err)
    with _counts_lock:
        CALLS[fn] += 1
