"""Build and bind the port's CUDA kernels (``llama_swift_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` into its own shared library with a plain
C interface and loaded with ``ctypes`` — no PyTorch headers, so a build takes
seconds.  All sources are compiled at once, one ``nvcc`` process each, at the
first call that needs any of them.  Libraries are named by the hash of their
source, of every header under ``csrc/`` (``*.cuh``, ``*.h``: the device code
that sources share) and of the compiler flags, and land in
``llama_swift_torch/_build/`` (listed in ``.gitignore``), so an edited
source or header is rebuilt and an unchanged one is reused.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

#: source stem -> {C function: argument types}; every function returns an
#: int: the ``cudaGetLastError()`` code after its launches (0 = launched),
#: or for the ``*_blocks``/``*_scratch_bytes``/``*_smem_bytes`` queries the value asked for
SOURCES = {
    "q4_matvec": {
        "q4_0_matvec": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
        "q4_0_matmul_multi": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
        "q4_0_matmul_multi_smem_bytes": [ctypes.c_int],
        "q4_0_int_matmul": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
        "q4_1_matvec": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
        "q4_0_matvec_f32": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
        "q4_1_matvec_f32": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    },
    "flash_decode": {
        "flash_decode": [ctypes.c_void_p] * 6
        + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
        "flash_decode_batched": [ctypes.c_void_p] * 7
        + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
        "flash_decode_paged": [ctypes.c_void_p] * 8
        + [ctypes.c_int] * 11 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
        "flash_decode_paged_smem_bytes": [ctypes.c_int] * 5,
        "flash_decode_batched_smem_bytes": [ctypes.c_int] * 5,
    },
    "q4_dequant": {
        "q4_0_dequant": [ctypes.c_void_p] * 3
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
        "q4_1_dequant": [ctypes.c_void_p] * 3
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
    },
    "q4_matmul_t": {
        "q4_0_f32_mma": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
        "q4_0_f32_mma_smem_bytes": [ctypes.c_int],
    },
    "fused_blocks": {
        "fused_ffn_block": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p],
        "fused_ffn_block_blocks": [ctypes.c_int] * 2,
        "fused_ffn_block_scratch_bytes": [ctypes.c_int] * 2,
    },
    "stream_probe": {
        "stream_probe": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    },
    "flash_prefill": {
        "flash_prefill": [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int]
        + [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p]
        + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p],
        "flash_prefill_smem_bytes": [ctypes.c_int] * 3,
    },
    "fused_layer": {
        "fused_layers": [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
        "fused_layers_blocks": [ctypes.c_int] * 3,
        "fused_layers_scratch_bytes": [ctypes.c_int] * 3,
        "fused_attn_block": [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
        "fused_attn_block_blocks": [ctypes.c_int] * 2,
        "fused_attn_block_splits": [ctypes.c_int] * 2,
        "fused_attn_block_split_keys": [ctypes.c_int] * 2,
        "fused_attn_block_scratch_bytes": [ctypes.c_int] * 2,
    },
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libs: dict = {}
_lock = threading.Lock()
#: seconds the last ``build_all`` took, and each library's ``-Xptxas -v``
#: report (registers, shared memory, spills), for chip_smoke.py's log
build_info: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a machine with the CUDA toolkit")
    return path


def source_digest(stem: str, csrc_dir: str = CSRC_DIR) -> str:
    """Rebuild key of ``<stem>.cu``: its bytes, every header of ``csrc_dir``
    and the compiler flags."""
    headers = sorted(f for f in os.listdir(csrc_dir) if f.endswith((".cuh", ".h")))
    h = hashlib.sha256()
    for name in [stem + ".cu"] + headers:
        with open(os.path.join(csrc_dir, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _lib_path(stem: str) -> str:
    return os.path.join(BUILD_DIR, f"{stem}-{source_digest(stem)}.so")


def build_all() -> dict:
    """Compile every source whose library is missing, all ``nvcc`` processes
    started together; returns {stem: library path}.  Raises with the
    compiler's output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    paths = {stem: _lib_path(stem) for stem in SOURCES}
    procs = {}
    for stem, path in paths.items():
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, stem + ".cu")]
        procs[stem] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    errors = []
    for stem, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_info[stem] = out
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {stem}.cu:\n{out}")
        else:
            os.replace(tmp, paths[stem])
    if errors:
        raise RuntimeError("\n".join(errors))
    build_info["seconds"] = time.perf_counter() - t0
    return paths


def lib(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built at first use."""
    with _lock:
        if stem not in _libs:
            paths = build_all()
            for name, path in paths.items():
                cdll = ctypes.CDLL(path)
                for fn, argtypes in SOURCES[name].items():
                    getattr(cdll, fn).argtypes = argtypes
                    getattr(cdll, fn).restype = ctypes.c_int
                _libs[name] = cdll
        return _libs[stem]


def check(code: int, what: str) -> None:
    """Raise if a C launcher reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {code}")
