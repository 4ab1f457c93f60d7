"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source in ``repro_torch/csrc/`` has a plain C interface and becomes its
own shared library under the checkout's ``build/`` directory, named by a
digest of its source and flags, so an edited source is rebuilt and an
unchanged one is not. Nothing is built at import: the first CUDA launch of a
kernel builds its library, and ``build()`` compiles several at once (one
``nvcc`` process per source, all started together).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("flash_attention", "decode_attention", "wkv6", "mamba2_ssd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=SOURCES, *, verbose: bool = False) -> dict[str, str]:
    """Compile every named source whose library is missing, in parallel.

    Returns each compiled source's ``nvcc`` messages (with ``verbose``,
    ``-Xptxas -v``'s registers and shared memory per kernel). Raises with the
    compiler's output if any compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).exists()]
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{logs[name]}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def kernel_info(lib: ctypes.CDLL, fn: str, knob: int, device=None) -> dict:
    """What ``lib.fn(knob, int[4])`` reports of a kernel instance on the
    card ``device`` (the current one by default): registers a thread, local
    (spilled) bytes a thread, dynamic shared memory a CTA, and CTAs a
    streaming multiprocessor holds at once."""
    import torch
    info = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        rc = getattr(lib, fn)(knob, info)
    if rc != 0:
        raise RuntimeError(f"{fn}({knob}) failed: cudaError {rc}")
    return dict(zip(("registers", "local_bytes", "smem_bytes",
                     "ctas_per_sm"), info))


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use, with
    ``argtypes`` and ``restype`` set from ``signatures``
    (function name -> (argtypes, restype))."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
        return lib
