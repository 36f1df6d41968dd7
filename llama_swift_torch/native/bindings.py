"""ctypes bindings for the port's native host runtime (``ggml_io.cpp``).

A copy of ``llama_swift_tpu/native/bindings.py`` with its own build: the
shared library is compiled with ``g++`` at first use into
``llama_swift_torch/_build/`` (listed in ``.gitignore``), named by a digest
of the source, the compiler flags and the host's ``-march=native`` target
(see :func:`library_path`), and written through a per-process
temporary file and ``os.replace``, so that processes building at the same
moment never load a half-written library.  ``available()`` returns False
(and the pure-Python paths are used) when no compiler exists.

The C ABI + ctypes is the binding layer: no build-time Python dependency.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "ggml_io.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LIB_ERR: Optional[str] = None


class _GioTensor(ctypes.Structure):
    _fields_ = [
        ("name", ctypes.c_char * 128),
        ("n_dims", ctypes.c_int32),
        ("ne", ctypes.c_int32 * 2),
        ("ftype", ctypes.c_int32),
        ("data_offset", ctypes.c_uint64),
        ("data_size", ctypes.c_uint64),
    ]


def library_path() -> str:
    """Where the library of this source, these flags and this host's
    ``-march=native`` lives: the key includes the target options g++
    resolves here, so a library built on another CPU is never loaded."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    target = subprocess.run(["g++", "-march=native", "-Q", "--help=target"], check=True,
                            capture_output=True).stdout
    h.update(target)
    return os.path.join(BUILD_DIR, f"ggml_io-{h.hexdigest()[:16]}.so")


def _build() -> str:
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *CXX_FLAGS, _SRC, "-o", tmp], check=True, capture_output=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_ERR
    with _LOCK:
        if _LIB is not None or _LIB_ERR is not None:
            return _LIB
        try:
            lib = ctypes.CDLL(_build())
        except Exception as e:  # no compiler / build failure → python fallback
            _LIB_ERR = str(e)
            return None
        lib.gio_open.restype = ctypes.c_void_p
        lib.gio_open.argtypes = [ctypes.c_char_p]
        lib.gio_error.restype = ctypes.c_char_p
        lib.gio_error.argtypes = [ctypes.c_void_p]
        lib.gio_close.argtypes = [ctypes.c_void_p]
        lib.gio_hparams.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
        lib.gio_n_tensors.restype = ctypes.c_int32
        lib.gio_n_tensors.argtypes = [ctypes.c_void_p]
        lib.gio_tensor.restype = ctypes.POINTER(_GioTensor)
        lib.gio_tensor.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.gio_base.restype = ctypes.c_void_p
        lib.gio_base.argtypes = [ctypes.c_void_p]
        lib.gio_vocab_piece.restype = ctypes.c_int32
        lib.gio_vocab_piece.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.POINTER(ctypes.c_void_p)]
        lib.gio_dequant_q4_0.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
        lib.gio_quantize_q4_0.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p]
        lib.gio_tokenizer_new.restype = ctypes.c_void_p
        lib.gio_tokenizer_new.argtypes = [ctypes.c_void_p]
        lib.gio_tokenizer_free.argtypes = [ctypes.c_void_p]
        lib.gio_tokenize.restype = ctypes.c_int32
        lib.gio_tokenize.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
        lib.gio_sampler_new.restype = ctypes.c_void_p
        lib.gio_sampler_new.argtypes = [ctypes.c_uint32]
        lib.gio_sampler_free.argtypes = [ctypes.c_void_p]
        lib.gio_sample_top_p_top_k.restype = ctypes.c_int32
        lib.gio_sample_top_p_top_k.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.c_double, ctypes.c_int32, ctypes.c_double, ctypes.c_double]
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


def loaded_path() -> Optional[str]:
    """The file of the loaded library (None until it is loaded)."""
    return None if _LIB is None else _LIB._name


class NativeModelFile:
    """mmap-backed GGML model: zero-copy numpy views of tensor data.

    The mapping is ``PROT_READ``, but numpy marks the views writable: a
    write through one faults, and so does a read after :meth:`close`.
    Callers copy what they keep (``formats/ggml.py`` does)."""

    def __init__(self, path: str):
        import numpy as np

        lib = _load()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {_LIB_ERR}")
        self._lib = lib
        self._h = lib.gio_open(path.encode())
        err = lib.gio_error(self._h)
        if err:
            msg = err.decode()
            lib.gio_close(self._h)
            self._h = None
            raise ValueError(msg)
        hp = (ctypes.c_int32 * 7)()
        lib.gio_hparams(self._h, hp)
        self.hparams = tuple(hp)
        base = lib.gio_base(self._h)
        self._base = base
        self.map_size = os.path.getsize(path)  # gio_open maps the whole file
        n = lib.gio_n_tensors(self._h)
        self.tensors: dict[str, dict] = {}
        for i in range(n):
            t = lib.gio_tensor(self._h, i).contents
            arr = np.ctypeslib.as_array(
                (ctypes.c_uint8 * t.data_size).from_address(base + t.data_offset)
            )
            self.tensors[t.name.decode()] = {
                "ne": tuple(t.ne[: t.n_dims]),
                "ftype": t.ftype,
                "raw": arr,  # zero-copy view into the mmap
            }

    def vocab(self) -> list[bytes]:
        out = []
        p = ctypes.c_void_p()
        i = 0
        while True:
            ln = self._lib.gio_vocab_piece(self._h, i, ctypes.byref(p))
            if ln < 0:
                break
            out.append(ctypes.string_at(p, ln) if ln else b"")
            i += 1
        return out

    def close(self):
        if self._h:
            self._lib.gio_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def dequant_q4_0(raw, rows: int, cols: int):
    """C dequantizer over interleaved row bytes → f32 [rows, cols]."""
    import numpy as np

    lib = _load()
    assert lib is not None
    src = np.ascontiguousarray(raw, dtype=np.uint8)
    dst = np.empty((rows, cols), dtype=np.float32)
    lib.gio_dequant_q4_0(
        src.ctypes.data_as(ctypes.c_void_p), dst.ctypes.data_as(ctypes.c_void_p),
        rows, cols,
    )
    return dst


def quantize_q4_0(x, with_hist: bool = False):
    import numpy as np

    lib = _load()
    assert lib is not None
    x = np.ascontiguousarray(x, dtype=np.float32)
    rows, cols = x.shape
    dst = np.empty((rows, cols // 32 * 20), dtype=np.uint8)
    hist = np.zeros(16, dtype=np.int64) if with_hist else None
    lib.gio_quantize_q4_0(
        x.ctypes.data_as(ctypes.c_void_p), dst.ctypes.data_as(ctypes.c_void_p),
        rows, cols,
        hist.ctypes.data_as(ctypes.c_void_p) if with_hist else None,
    )
    return (dst, hist) if with_hist else dst


class NativeTokenizer:
    def __init__(self, model: NativeModelFile):
        self._lib = model._lib
        self._t = self._lib.gio_tokenizer_new(model._h)

    def tokenize(self, text, bos: bool = False) -> list[int]:
        data = text.encode("utf-8") if isinstance(text, str) else bytes(text)
        cap = len(data) + 2
        out = (ctypes.c_int32 * cap)()
        n = self._lib.gio_tokenize(self._t, data, len(data), int(bos), out, cap)
        return list(out[:n])

    def __del__(self):
        try:
            self._lib.gio_tokenizer_free(self._t)
        except Exception:
            pass


class NativeSampler:
    """Reference sampler with a true std::mt19937 — bit-compatible with the
    reference's RNG stream (``LlamaPredictOperation.mm:773``)."""

    def __init__(self, seed: int):
        lib = _load()
        assert lib is not None
        self._lib = lib
        self._s = lib.gio_sampler_new(ctypes.c_uint32(seed & 0xFFFFFFFF))

    def sample(self, logits, last_n, *, repeat_penalty, top_k, top_p, temp) -> int:
        import numpy as np

        logits = np.ascontiguousarray(logits, dtype=np.float32)
        arr = (ctypes.c_int32 * len(last_n))(*last_n)
        return self._lib.gio_sample_top_p_top_k(
            self._s, logits.ctypes.data_as(ctypes.c_void_p), len(logits),
            arr, len(last_n),
            ctypes.c_double(repeat_penalty), ctypes.c_int32(top_k),
            ctypes.c_double(top_p), ctypes.c_double(temp),
        )

    def __del__(self):
        try:
            self._lib.gio_sampler_free(self._s)
        except Exception:
            pass
