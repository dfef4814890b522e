"""Build and load the CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled at first use with ``nvcc`` into a shared
library with a plain C interface, under ``build/`` (listed in .gitignore),
and loaded with ``ctypes``. The library's file name carries a hash of every
source under ``csrc/``, so an edited source is rebuilt. Each C entry returns
``cudaGetLastError()``; ``check`` raises on a non-zero code.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
SOURCES = ("ntt", "poseidon")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# argtypes of every C entry, by library
SIGNATURES = {
    "ntt": {
        "city_ntt_k1": (_P, _P, _P, _P, _P, _LL) + (_I,) * 6 + (_P,),
        "city_ntt_k2": (_P, _P, _P, _P, _LL) + (_I,) * 7 + (_P,),
        "city_ntt_tail": (_P, _P, _P, _LL, _I, _I, _P),
    },
    "poseidon": {
        "city_poseidon_init": (_P, _LL),
        "city_poseidon_permute": (_P, _P, _LL, _P),
        "city_poseidon_sponge": (_P, _P, _I, _LL, _P),
        "city_poseidon_absorb": (_P, _P, _P, _I, _LL, _P),
        "city_poseidon_merkle_level": (_P, _P, _LL, _P),
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _digest() -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD / f"lib{name}-{_digest()}.so"


def _compile_cmd(name: str, out: Path) -> list[str]:
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names=SOURCES) -> dict[str, str]:
    """Compile every library that is missing, one ``nvcc`` per source, all
    started together. Returns each compiler's output (register and shared
    memory use per kernel, from ``-Xptxas -v``); raises if one fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _compile_cmd(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    logs = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def kernel_name(mangled: str) -> str:
    """A kernel's source name from its mangled one (the length-prefixed
    identifier that ends in ``_kernel``), with ``<true>`` or ``<false>``
    for a bool template argument."""
    m = re.search(r"_kernel(?:ILb([01])E)?", mangled)
    if not m:
        return mangled
    end = m.start() + len("_kernel")
    for length in range(len("_kernel") + 1, end + 1):
        digits = str(length)
        start = end - length
        if mangled[start - len(digits):start] == digits and \
                mangled[start].isalpha():
            return mangled[start:end] + {"0": "<false>", "1": "<true>",
                                         None: ""}[m.group(1)]
    return mangled


def ptxas_usage(log: str) -> dict:
    """{kernel: {"registers", "spill_stores", "spill_loads"}} from a
    ``build`` log (``-Xptxas -v``), each kernel by its source name."""
    out: dict = {}
    cur = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = out.setdefault(kernel_name(m.group(1)), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"] = int(m.group(1))
            cur["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build((name,))
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc}")


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as an address."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(what: str, *tensors: torch.Tensor) -> None:
    """A kernel wrapper's checks: every tensor int64, contiguous and on
    the first one's CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{what}: tensors must share one CUDA device")
        if t.dtype != torch.int64:
            raise TypeError(f"{what}: expected int64, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
