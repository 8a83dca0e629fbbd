"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers, so one
``nvcc`` call takes seconds, not minutes) and is compiled for Hopper
(``sm_90a``) into ``repro_torch/build/lib<name>-<hash>.so`` beside the
package's own sources on first use, then loaded with :mod:`ctypes`.  The file
name carries a hash of the source and of the ``csrc`` headers it includes,
so an edited kernel or header is rebuilt and a stale library is never
loaded.  ``build/`` is listed in ``.gitignore``.

Every C entry point takes its pointers and the CUDA stream as ``void*``
(``ctypes.c_void_p``: a plain ``c_int`` would cut a 64-bit pointer) and
returns ``cudaGetLastError()`` after its launch; :func:`check` raises on a
non-zero code.  Nothing here falls back: a missing ``nvcc`` or a failed build
raises.

:func:`load` is safe to call from several threads (replicas of the engine,
each on its own loop thread, reach a kernel's first use together): one lock
covers build and load, so a library is compiled once per process.
:func:`count_launch` is the wrappers' launch counter, under a lock for the
same reason.  Inside :func:`recording_launches` a thread's launches go to a
table of its own instead, and only while its current stream captures: a
CUDA graph's capture launches nothing, and each replay adds the table back
(:func:`add_launches`), so ``launches`` counts what the card ran.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Iterable, Iterator, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[1] / "build"
_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry point and argument types of each kernel library
SIGNATURES = {
    "decode_attention": ("decode_attention_launch",
                         [_PTR] * 6 + [_INT] * 7 + [_LL] * 7 + [_PTR]),
    "flash_attention": ("flash_attention_launch",
                        [_PTR] * 7 + [_INT] * 10 + [_LL] * 6 + [_PTR]),
    "flash_attention_bwd": ("flash_attention_bwd_launch",
                            [_PTR] * 10 + [_INT] * 9 + [_PTR]),
    "paged_attention": ("paged_attention_launch",
                        [_PTR] * 9 + [_INT] * 9 + [_LL] * 13 + [_PTR]),
    "quant_matmul": ("quant_matmul_launch", [_PTR] * 5 + [_INT] * 6 + [_PTR]),
    # one packed struct (kernels/rmsnorm.py ARGS, csrc/rmsnorm.cu RmsnormArgs)
    "rmsnorm": ("rmsnorm_launch", [ctypes.c_char_p]),
    "categorical": ("categorical_launch",
                    [_PTR] * 6 + [_INT] * 4 + [_LL] * 5 + [_PTR]),
}
KERNELS = tuple(SIGNATURES)
CUDA_HOMES = ("/usr/local/cuda",)   # toolkit locations tried after the env
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
_RECORDING = threading.local()      # .table: wrapper -> launches, or None


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``$CUDA_PATH/bin/nvcc``,
    one under :data:`CUDA_HOMES`, or ``nvcc`` on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 *CUDA_HOMES):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit "
                           "that builds the port's kernels")
    return found


def sources(name: str) -> list:
    """``csrc/<name>.cu`` and the ``csrc`` headers it includes with
    ``#include "..."``, transitively, in first-seen order."""
    found, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        todo += [CSRC / inc for inc in _INCLUDE.findall(path.read_text())]
    return found


def _lib_path(name: str) -> Path:
    """The library's path, named by a hash of its source, every header the
    source includes and the compiler flags."""
    digest = hashlib.sha256()
    for path in sources(name):
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every named kernel whose library is missing — one ``nvcc``
    process per source, all started together — and return the seconds
    each took (0.0 for a library already built).  ``ptxas`` register and
    shared-memory reports go to ``build/<name>.log``."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(BUILD / f"{name}.log", "w")
        procs[name] = (subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, out, log, time.time())
    took = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out, log, t0) in procs.items():
        rc = proc.wait()
        log.close()
        took[name] = time.time() - t0
        if rc != 0:
            failed.append(f"{name}: nvcc exited {rc}\n"
                          + (BUILD / f"{name}.log").read_text()[-4000:])
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return took


def load(name: str):
    """The C entry point of one kernel (its library built first if needed)
    and the library itself."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                build([name])
                lib = ctypes.CDLL(str(_lib_path(name)))
                entry, argtypes = SIGNATURES[name]
                getattr(lib, entry).argtypes = argtypes
                getattr(lib, entry).restype = ctypes.c_int
                lib.kernel_error_string.argtypes = [ctypes.c_int]
                lib.kernel_error_string.restype = ctypes.c_char_p
                _LIBS[name] = lib
    return getattr(lib, SIGNATURES[name][0]), lib


def count_launch(wrapper) -> None:
    """Add one to a kernel wrapper's ``launches`` (atomic across threads),
    or to the calling thread's table while it records.  A recorded launch
    must have gone into the graph: the wrappers launch on the current
    stream, so that stream has to be capturing."""
    table = getattr(_RECORDING, "table", None)
    if table is not None:
        import torch
        if not (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing()):
            raise RuntimeError(
                f"{getattr(wrapper, '__name__', wrapper)} launched while its "
                "thread records a capture, on a stream that does not capture")
        table[wrapper] = table.get(wrapper, 0) + 1
        return
    with _COUNT_LOCK:
        wrapper.launches += 1


@contextmanager
def recording_launches() -> Iterator[Dict]:
    """Count the calling thread's launches into the yielded table (wrapper
    -> launches) and leave the wrappers' counters alone: around a CUDA
    graph's capture, which records launches without running them."""
    table: Dict = {}
    _RECORDING.table = table
    try:
        yield table
    finally:
        _RECORDING.table = None


def add_launches(table: Dict) -> None:
    """Add a recorded table to the wrappers' counters (a graph's replay)."""
    with _COUNT_LOCK:
        for wrapper, n in table.items():
            wrapper.launches += n


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if code != 0:
        msg: Optional[bytes] = lib.kernel_error_string(code)
        raise RuntimeError(f"{what}: CUDA error {code} "
                           f"({msg.decode() if msg else 'unknown'})")
