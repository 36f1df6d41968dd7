"""Offline quantizer CLI — parity with ``Sources/cpp/quantize.cpp``.

Usage (same argument shape as the reference, ``quantize.cpp:291-338``)::

    python -m llama_swift_torch.tools.quantize model-f16.bin model-q4_0.bin 2

itype 2 → Q4_0, 3 → Q4_1 (the GGML header's f16 field is rewritten to the
itype, ``quantize.cpp:116``).  Behavior replicated:

* only 2-D tensors whose name matches ``.*weight`` are quantized
  (``quantize.cpp:171-185``) — incl. tok_embeddings and output; 1-D norms
  pass through as f32;
* per-tensor progress lines with sizes and 16-bucket nibble histograms plus
  the aggregate histogram (``quantize.cpp:244-286``);
* the Q4_1 path uses the tool-variant FLT_MIN max-init quirk
  (``utils.cpp:505``) for bit parity with reference-produced files.

Streams record-by-record; memory use is one tensor at a time.  Numpy only:
the port's copy of ``llama_swift_tpu/tools/quantize.py``, on the port's own
``formats/{ggml,quant}``; it writes the same bytes.
"""

from __future__ import annotations

import dataclasses
import re
import sys
import time

import numpy as np

from ..config import GGMLType
from ..formats import ggml
from ..formats.quant import Q4_0Tensor, Q4_1Tensor

FTYPE_STR = ["f32", "f16", "q4_0", "q4_1"]
QUANTIZE_NAME_PATTERNS = [r".*weight"]


def quantize_model_file(fname_in: str, fname_out: str, itype: int, *, log=print) -> bool:
    if itype not in (2, 3):
        raise ValueError(f"invalid quantization type {itype}")
    qtype = GGMLType(itype)

    with open(fname_in, "rb") as finp, open(fname_out, "wb") as fout:
        cfg = ggml.read_header(finp)
        vocab = ggml.read_vocab(finp, cfg.n_vocab)
        ggml.write_header(fout, dataclasses.replace(cfg, ftype=qtype))
        ggml.write_vocab(fout, vocab)

        total_org = 0
        total_new = 0
        hist_all = np.zeros(16, dtype=np.int64)

        for rec in ggml.iter_tensor_records(finp):
            quantize = any(
                re.fullmatch(p, rec.name) for p in QUANTIZE_NAME_PATTERNS
            ) and len(rec.ne) == 2
            log(
                f"{rec.name:>48s} - [{rec.ne[0]:5d}, {rec.ne[1] if len(rec.ne) > 1 else 1:5d}],"
                f" type = {FTYPE_STR[int(rec.ftype)]:>6s} ",
                end="",
            )
            nelements = int(np.prod(rec.shape))
            total_org += nelements * 4
            if quantize:
                if rec.ftype not in (GGMLType.F32, GGMLType.F16):
                    log(f"\nunsupported ftype {rec.ftype} for integer quantization")
                    return False
                data = np.asarray(rec.to_array(), dtype=np.float32)
                if qtype == GGMLType.Q4_0:
                    qt = Q4_0Tensor.quantize(data)
                else:
                    qt = Q4_1Tensor.quantize(data, tool_compat=True)
                ggml.write_tensor_record(fout, rec.name, qt)
                hist = qt.nibble_histogram()
                hist_all += hist
                new_sz = qt.to_row_bytes().nbytes
                total_new += new_sz
                log(
                    f"quantizing .. size = {nelements * 4 / 1024 / 1024:8.2f} MB -> "
                    f"{new_sz / 1024 / 1024:8.2f} MB | hist: "
                    + " ".join(f"{h / nelements:5.3f}" for h in hist)
                )
            else:
                arr = rec.to_array()
                ggml.write_tensor_record(fout, rec.name, arr, ftype=rec.ftype)
                sz = rec.data.nbytes
                total_new += sz
                log(f"size = {sz / 1024 / 1024:8.3f} MB")

        log(f"model size  = {total_org / 1024 / 1024:8.2f} MB")
        log(f"quant size  = {total_new / 1024 / 1024:8.2f} MB")
        s = hist_all.sum()
        if s:
            log("hist: " + " ".join(f"{h / s:5.3f}" for h in hist_all))
    return True


def _log_print(msg, end="\n"):
    print(msg, end=end, flush=True)


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 3:
        print(f"usage: {sys.argv[0]} model-f32.bin model-quant.bin type")
        print("  type = 2 - q4_0")
        print("  type = 3 - q4_1")
        return 1
    t0 = time.time()
    ok = quantize_model_file(argv[0], argv[1], int(argv[2]), log=_log_print)
    if not ok:
        print(f"failed to quantize model from '{argv[0]}'")
        return 1
    print(f"quantize time = {(time.time() - t0) * 1000:8.2f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
