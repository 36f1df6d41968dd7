"""GGML model-file reader/writer (the reference's only serialization format).

File layout (produced by ``tools/convert-pth-to-ggml.py:92-169`` and consumed
by ``llama_model_load``, ``LlamaPredictOperation.mm:98-498``):

* i32 magic ``0x67676d6c``
* hparams: i32 × {n_vocab, n_embd, n_mult, n_head, n_layer, n_rot, f16}
  (``n_ctx`` deliberately absent — ``LlamaPredictOperation.mm:125``)
* vocab: n_vocab × [u32 len][len bytes] (``:150-163``)
* tensor records until EOF:
  [i32 n_dims][i32 name_len][i32 ftype][i32 ne[n_dims], fastest-dim first]
  [name bytes][raw row-major data, no padding] (``:306-345``)

Multi-part checkpoints (13B=2, 30B=4, 65B=8 parts; ``LLAMA_N_PARTS``):
part *i*>0 lives at ``<path>.<i>`` with an identical header/vocab section and
Megatron-style shards of each 2-D tensor.  The merge rule
(``LlamaPredictOperation.mm:358-388, 446-490``):

* split_type 0 — concatenate along ne[0] (the contiguous/column dim; numpy
  axis 1): ``tok_embeddings``, ``*.attention.wo.weight``,
  ``*.feed_forward.w2.weight``
* split_type 1 — concatenate along ne[1] (rows; numpy axis 0): ``output``,
  wq/wk/wv, w1/w3
* 1-D tensors are replicated: part 0 is read, other parts skipped (``:452-458``)

This module is pure host code (numpy), a copy of
``llama_swift_tpu/formats/ggml.py``.  Single-part files load through the
port's native mmap parser (``native/ggml_io.cpp``) when its library builds;
multi-part files, and machines with no C++ compiler, take the Python reader.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import BinaryIO, Iterator, Optional, Union

import numpy as np

from ..config import GGML_MAGIC, GGMLType, ModelConfig
from . import quant
from .quant import Q4_0Tensor, Q4_1Tensor


class GGMLFormatError(ValueError):
    """Malformed model file (maps to LlamaErrorCodeFailedToLoadModel)."""


# ---------------------------------------------------------------------------
# Split-type policy
# ---------------------------------------------------------------------------


def split_type_for(name: str) -> int:
    """0 = split along ne[0] (columns), 1 = split along ne[1] (rows).

    Substring policy exactly as ``LlamaPredictOperation.mm:358-388``.
    """
    if "tok_embeddings" in name:
        return 0
    if "layers" in name:
        if "attention.wo.weight" in name:
            return 0
        if "feed_forward.w2.weight" in name:
            return 0
        return 1
    if "output" in name:
        return 1
    return 0


# ---------------------------------------------------------------------------
# Low-level record IO
# ---------------------------------------------------------------------------


def _read_i32(f: BinaryIO) -> int:
    b = f.read(4)
    if len(b) < 4:
        raise EOFError
    return struct.unpack("<i", b)[0]


@dataclasses.dataclass
class TensorRecord:
    name: str
    ne: tuple[int, ...]  # fastest-dim-first, as stored
    ftype: GGMLType
    data: np.ndarray  # raw bytes, shape [rows, row_nbytes] (2-D) or [nbytes] (1-D)

    @property
    def shape(self) -> tuple[int, ...]:
        """numpy (row-major) shape: reversed ne."""
        return tuple(reversed(self.ne))

    def to_array(self) -> Union[np.ndarray, Q4_0Tensor, Q4_1Tensor]:
        """Decode raw bytes to a numpy array (f32/f16) or quantized wrapper."""
        if self.ftype == GGMLType.F32:
            return self.data.reshape(-1).view("<f4").reshape(self.shape).copy()
        if self.ftype == GGMLType.F16:
            return self.data.reshape(-1).view("<f2").reshape(self.shape).copy()
        rows = self.shape[0] if len(self.ne) == 2 else 1
        raw = self.data.reshape(rows, -1)
        if self.ftype == GGMLType.Q4_0:
            return Q4_0Tensor.from_row_bytes(raw)
        if self.ftype == GGMLType.Q4_1:
            return Q4_1Tensor.from_row_bytes(raw)
        raise GGMLFormatError(f"unknown ftype {self.ftype}")


def read_header(f: BinaryIO, n_ctx: int = 512) -> ModelConfig:
    magic = struct.unpack("<I", f.read(4))[0]
    if magic != GGML_MAGIC:
        raise GGMLFormatError(f"invalid model file (bad magic 0x{magic:08x})")
    n_vocab = _read_i32(f)
    n_embd = _read_i32(f)
    n_mult = _read_i32(f)
    n_head = _read_i32(f)
    n_layer = _read_i32(f)
    n_rot = _read_i32(f)
    f16 = _read_i32(f)
    try:
        ftype = GGMLType(f16)
    except ValueError:
        raise GGMLFormatError(f"invalid model file (bad f16 value {f16})")
    return ModelConfig(
        n_vocab=n_vocab, n_embd=n_embd, n_mult=n_mult, n_head=n_head,
        n_layer=n_layer, n_rot=n_rot, ftype=ftype, n_ctx=n_ctx,
    )


def read_vocab(f: BinaryIO, n_vocab: int) -> list[bytes]:
    """Length-prefixed byte pieces (``LlamaPredictOperation.mm:150-163``).
    Pieces may be invalid UTF-8 (byte-fallback tokens) — kept as bytes."""
    pieces = []
    for _ in range(n_vocab):
        (ln,) = struct.unpack("<I", f.read(4))
        pieces.append(f.read(ln))
    return pieces


def iter_tensor_records(f: BinaryIO) -> Iterator[TensorRecord]:
    """Stream tensor records until EOF (``LlamaPredictOperation.mm:330-345``)."""
    while True:
        try:
            n_dims = _read_i32(f)
        except EOFError:
            return
        name_len = _read_i32(f)
        ftype = GGMLType(_read_i32(f))
        ne = tuple(_read_i32(f) for _ in range(n_dims))
        name = f.read(name_len).decode("utf-8")
        if n_dims == 1:
            nbytes = quant.row_nbytes(ftype, ne[0]) if ftype in (
                GGMLType.Q4_0, GGMLType.Q4_1) else ne[0] * (4 if ftype == GGMLType.F32 else 2)
            raw = np.frombuffer(f.read(nbytes), dtype=np.uint8).reshape(1, nbytes)
        elif n_dims == 2:
            rowb = quant.row_nbytes(ftype, ne[0])
            nbytes = rowb * ne[1]
            raw = np.frombuffer(f.read(nbytes), dtype=np.uint8).reshape(ne[1], rowb)
        else:
            raise GGMLFormatError(f"unsupported n_dims {n_dims} for '{name}'")
        yield TensorRecord(name=name, ne=ne, ftype=ftype, data=raw)


# ---------------------------------------------------------------------------
# Whole-model loading with multi-part merge
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GGMLModelFile:
    config: ModelConfig
    vocab: list[bytes]
    tensors: dict[str, Union[np.ndarray, Q4_0Tensor, Q4_1Tensor]]
    #: when loaded through the native mmap path, the mapping's owner
    #: (``native.bindings.NativeModelFile``); ``tensors`` own their memory,
    #: so closing it leaves them valid
    native_handle: object = None


def _owned(arr, raw: np.ndarray):
    """``arr`` (an array, or a Q4 wrapper's arrays) with every part that
    still views ``raw`` copied.  The mapping is read-only although numpy
    marks its views writable, and it goes away with ``close()``; a tensor
    that aliased it would fault on an in-place op or after the close."""
    if isinstance(arr, np.ndarray):
        return arr.copy() if np.may_share_memory(arr, raw) else arr
    return dataclasses.replace(arr, **{f.name: _owned(getattr(arr, f.name), raw) for f in dataclasses.fields(arr)})


def _load_model_file_native(path: str, n_ctx: int, *, dequantize: bool) -> GGMLModelFile:
    """Single-part load via the C++ mmap parser (``native/ggml_io.cpp``)."""
    from ..native import bindings as nb

    if not os.path.exists(path):
        raise FileNotFoundError(path)
    try:
        nm = nb.NativeModelFile(path)
    except ValueError as e:
        raise GGMLFormatError(str(e)) from e
    n_vocab, n_embd, n_mult, n_head, n_layer, n_rot, f16 = nm.hparams
    try:
        ftype = GGMLType(f16)
    except ValueError:
        nm.close()
        raise GGMLFormatError(f"invalid model file (bad f16 value {f16})")
    cfg = ModelConfig(
        n_vocab=n_vocab, n_embd=n_embd, n_mult=n_mult, n_head=n_head,
        n_layer=n_layer, n_rot=n_rot, ftype=ftype, n_ctx=n_ctx,
    )
    shapes = expected_tensor_shapes(cfg)
    tensors: dict[str, Union[np.ndarray, Q4_0Tensor, Q4_1Tensor]] = {}
    for name, info in nm.tensors.items():
        if name not in shapes:
            nm.close()
            raise GGMLFormatError(f"unknown tensor '{name}' in model file")
        full = shapes[name]
        shape = tuple(reversed(info["ne"]))
        if shape != full:
            nm.close()
            raise GGMLFormatError(f"tensor '{name}' has wrong shape in model file")
        rec = TensorRecord(
            name=name, ne=info["ne"], ftype=GGMLType(info["ftype"]),
            data=info["raw"].reshape(shape[0] if len(shape) == 2 else 1, -1),
        )
        arr = rec.to_array()
        if len(shape) == 1 and isinstance(arr, np.ndarray):
            arr = arr.reshape(-1)
        if dequantize and isinstance(arr, (Q4_0Tensor, Q4_1Tensor)):
            arr = arr.dequantize()
        tensors[name] = _owned(arr, info["raw"])
    missing = set(shapes) - set(tensors)
    if missing:
        nm.close()
        raise GGMLFormatError(f"missing tensors in model file: {sorted(missing)[:5]}")
    return GGMLModelFile(config=cfg, vocab=nm.vocab(), tensors=tensors,
                         native_handle=nm)


def part_paths(path: str, n_parts: int) -> list[str]:
    """Part 0 at ``path``, part i at ``path.i`` (``LlamaPredictOperation.mm:316-321``)."""
    return [path if i == 0 else f"{path}.{i}" for i in range(n_parts)]


def expected_tensor_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """Full (merged) numpy shapes of every model tensor, per the loader's
    tensor construction (``LlamaPredictOperation.mm:236-287``).

    2-D ggml ``ne=(in, out)`` ⇒ numpy ``[out, in]``.
    """
    D, V, F = cfg.n_embd, cfg.n_vocab, cfg.n_ff
    shapes: dict[str, tuple[int, ...]] = {
        "tok_embeddings.weight": (V, D),
        "norm.weight": (D,),
        "output.weight": (V, D),
    }
    for i in range(cfg.n_layer):
        p = f"layers.{i}."
        shapes[p + "attention_norm.weight"] = (D,)
        shapes[p + "attention.wq.weight"] = (D, D)
        shapes[p + "attention.wk.weight"] = (D, D)
        shapes[p + "attention.wv.weight"] = (D, D)
        shapes[p + "attention.wo.weight"] = (D, D)
        shapes[p + "ffn_norm.weight"] = (D,)
        shapes[p + "feed_forward.w1.weight"] = (F, D)
        shapes[p + "feed_forward.w2.weight"] = (D, F)
        shapes[p + "feed_forward.w3.weight"] = (F, D)
    return shapes


def _merge_part_raw(
    parts: list[TensorRecord], name: str, full_shape: tuple[int, ...]
) -> TensorRecord:
    """Merge per-part raw byte blocks per split_type (col/row concat).

    Column (split_type 0) merges concatenate each row's byte segment — valid
    for all dtypes because Q4 rows are whole blocks (loader asserts
    ``ne[0] % 64 == 0``, ``LlamaPredictOperation.mm:441``) and the Q4_1 planar
    row layout is also per-part rows... Q4_1 planar rows cannot be merged by
    byte concat; parts are decoded then re-encoded for that case.
    """
    first = parts[0]
    if len(parts) == 1:
        return first
    st = split_type_for(name)
    if first.ftype == GGMLType.Q4_1:
        # planar row layout: decode each part, merge values, re-encode is
        # lossless (nibbles+scales preserved by construction)
        decoded = [p.to_array() for p in parts]
        if st == 0:
            mins = np.concatenate([d.mins for d in decoded], axis=1)
            scales = np.concatenate([d.scales for d in decoded], axis=1)
            qs = np.concatenate([d.qs for d in decoded], axis=1)
        else:
            mins = np.concatenate([d.mins for d in decoded], axis=0)
            scales = np.concatenate([d.scales for d in decoded], axis=0)
            qs = np.concatenate([d.qs for d in decoded], axis=0)
        merged = Q4_1Tensor(mins, scales, qs)
        return TensorRecord(
            name=name,
            ne=(merged.shape[1], merged.shape[0]),
            ftype=GGMLType.Q4_1,
            data=merged.to_row_bytes(),
        )
    axis = 1 if st == 0 else 0  # numpy axis: cols for split 0, rows for split 1
    raw = np.concatenate([p.data for p in parts], axis=axis)
    ne0 = full_shape[1] if st == 0 else first.ne[0]
    ne1 = first.ne[1] if st == 0 else full_shape[0]
    return TensorRecord(name=name, ne=(ne0, ne1), ftype=first.ftype, data=raw)


def load_model_file(
    path: str,
    n_ctx: int = 512,
    *,
    n_parts: Optional[int] = None,
    dequantize: bool = False,
    use_native: Optional[bool] = None,
) -> GGMLModelFile:
    """Load (and if multi-part, merge) a GGML model file.

    With ``dequantize=True`` Q4 tensors are decoded to f32 numpy arrays;
    otherwise they stay as packed :class:`Q4_0Tensor`/:class:`Q4_1Tensor`.
    f16 tensors stay f16.

    ``use_native`` (default: auto) routes single-part loads through the
    mmap'd C++ parser (``native/ggml_io.cpp``) — zero read() copies; the
    Python reader is the fallback and the multi-part path.
    """
    if use_native is not False and (n_parts is None or n_parts == 1):
        try:
            from ..native import bindings as nb

            if (use_native or nb.available()) and not os.path.exists(f"{path}.1"):
                return _load_model_file_native(path, n_ctx, dequantize=dequantize)
        except (ImportError, RuntimeError):
            if use_native:
                raise
    with open(path, "rb") as f:
        cfg = read_header(f, n_ctx)
        vocab = read_vocab(f, cfg.n_vocab)
        data_offset = f.tell()

    if n_parts is None:
        n_parts = cfg.n_parts
        # fall back to single part when sibling files are absent (e.g. test
        # fixtures with production n_embd)
        if n_parts > 1 and not os.path.exists(f"{path}.1"):
            n_parts = 1

    shapes = expected_tensor_shapes(cfg)
    per_part: dict[str, list[TensorRecord]] = {}
    for part_id, ppath in enumerate(part_paths(path, n_parts)):
        with open(ppath, "rb") as f:
            f.seek(data_offset)
            for rec in iter_tensor_records(f):
                if rec.name not in shapes:
                    raise GGMLFormatError(f"unknown tensor '{rec.name}' in model file")
                full = shapes[rec.name]
                if len(rec.ne) == 1:
                    if rec.shape != full:
                        raise GGMLFormatError(
                            f"tensor '{rec.name}' has wrong size in model file"
                        )
                    if part_id == 0:
                        per_part[rec.name] = [rec]
                    continue  # 1-D replicated: parts >0 skipped (.mm:452-458)
                st = split_type_for(rec.name)
                exp_ne0 = full[1] // n_parts if st == 0 else full[1]
                exp_ne1 = full[0] if st == 0 else full[0] // n_parts
                if rec.ne != (exp_ne0, exp_ne1):
                    raise GGMLFormatError(
                        f"tensor '{rec.name}' has wrong shape in model file: "
                        f"got {rec.ne}, expected {(exp_ne0, exp_ne1)}"
                    )
                per_part.setdefault(rec.name, []).append(rec)

    tensors: dict[str, Union[np.ndarray, Q4_0Tensor, Q4_1Tensor]] = {}
    for name, recs in per_part.items():
        if len(recs) != 1 and len(recs) != n_parts:
            raise GGMLFormatError(
                f"tensor '{name}' present in {len(recs)}/{n_parts} parts"
            )
        merged = _merge_part_raw(recs, name, shapes[name])
        arr = merged.to_array()
        if len(merged.ne) == 1 and isinstance(arr, np.ndarray):
            arr = arr.reshape(-1)
        if dequantize and isinstance(arr, (Q4_0Tensor, Q4_1Tensor)):
            arr = arr.dequantize()
        tensors[name] = arr

    missing = set(shapes) - set(tensors)
    if missing:
        raise GGMLFormatError(f"missing tensors in model file: {sorted(missing)[:5]}")
    return GGMLModelFile(config=cfg, vocab=vocab, tensors=tensors)


# ---------------------------------------------------------------------------
# Writer (converter/quantizer tools + test fixtures)
# ---------------------------------------------------------------------------


def write_header(f: BinaryIO, cfg: ModelConfig) -> None:
    f.write(struct.pack("<I", GGML_MAGIC))
    for v in (cfg.n_vocab, cfg.n_embd, cfg.n_mult, cfg.n_head, cfg.n_layer,
              cfg.n_rot, int(cfg.ftype)):
        f.write(struct.pack("<i", v))


def write_vocab(f: BinaryIO, pieces: list[bytes]) -> None:
    for p in pieces:
        f.write(struct.pack("<I", len(p)))
        f.write(p)


def write_tensor_record(
    f: BinaryIO,
    name: str,
    array: Union[np.ndarray, Q4_0Tensor, Q4_1Tensor],
    ftype: Optional[GGMLType] = None,
) -> None:
    """Write one record (layout per ``convert-pth-to-ggml.py:162-169``)."""
    if isinstance(array, Q4_0Tensor):
        raw, ftype = array.to_row_bytes(), GGMLType.Q4_0
        shape = array.shape
    elif isinstance(array, Q4_1Tensor):
        raw, ftype = array.to_row_bytes(), GGMLType.Q4_1
        shape = array.shape
    else:
        array = np.asarray(array)
        if ftype is None:
            ftype = GGMLType.F16 if array.dtype == np.float16 else GGMLType.F32
        dt = "<f2" if ftype == GGMLType.F16 else "<f4"
        raw = np.ascontiguousarray(array.astype(dt)).view(np.uint8)
        shape = array.shape
    ne = tuple(reversed(shape))
    sname = name.encode("utf-8")
    f.write(struct.pack("<iii", len(ne), len(sname), int(ftype)))
    for d in ne:
        f.write(struct.pack("<i", d))
    f.write(sname)
    f.write(np.ascontiguousarray(raw).tobytes())


def write_model_file(
    path: str,
    cfg: ModelConfig,
    vocab: list[bytes],
    tensors: dict[str, Union[np.ndarray, Q4_0Tensor, Q4_1Tensor]],
    *,
    n_parts: int = 1,
) -> None:
    """Write a model file, optionally split into n_parts shards with the
    reference's split_type rules (for round-trip tests of the merge path)."""
    for part_id in range(n_parts):
        ppath = part_paths(path, n_parts)[part_id]
        with open(ppath, "wb") as f:
            write_header(f, cfg)
            write_vocab(f, vocab)
            for name, arr in tensors.items():
                shard = _shard_for_part(name, arr, part_id, n_parts)
                if shard is not None:
                    write_tensor_record(f, name, shard)


def _shard_for_part(name, arr, part_id, n_parts):
    if n_parts == 1:
        return arr
    if isinstance(arr, np.ndarray) and arr.ndim == 1:
        return arr  # replicated in every part
    st = split_type_for(name)
    if isinstance(arr, Q4_0Tensor):
        if st == 0:
            nb = arr.scales.shape[1] // n_parts
            return Q4_0Tensor(
                arr.scales[:, part_id * nb : (part_id + 1) * nb],
                arr.qs[:, part_id * nb * 16 : (part_id + 1) * nb * 16],
            )
        r = arr.scales.shape[0] // n_parts
        sl = slice(part_id * r, (part_id + 1) * r)
        return Q4_0Tensor(arr.scales[sl], arr.qs[sl])
    if isinstance(arr, Q4_1Tensor):
        if st == 0:
            nb = arr.scales.shape[1] // n_parts
            bs = slice(part_id * nb, (part_id + 1) * nb)
            return Q4_1Tensor(
                arr.mins[:, bs], arr.scales[:, bs],
                arr.qs[:, part_id * nb * 16 : (part_id + 1) * nb * 16],
            )
        r = arr.scales.shape[0] // n_parts
        sl = slice(part_id * r, (part_id + 1) * r)
        return Q4_1Tensor(arr.mins[sl], arr.scales[sl], arr.qs[sl])
    axis = 1 if st == 0 else 0
    n = arr.shape[axis] // n_parts
    sl = [slice(None), slice(None)]
    sl[axis] = slice(part_id * n, (part_id + 1) * n)
    return arr[tuple(sl)]
