"""PyTorch-checkpoint → GGML converter — parity with
``tools/convert-pth-to-ggml.py`` (the port's copy of
``llama_swift_tpu/tools/convert_pth.py``: the same usage, part table, vocab
rules, record layout and output files, byte for byte).

Usage::

    python -m llama_swift_torch.tools.convert_pth <dir-model> <ftype>
        # ftype 0 = f32, 1 = f16 (default)

Reads ``<dir>/params.json``, ``<dir>/../tokenizer.model`` (SentencePiece) and
``consolidated.0N.pth`` parts; writes ``ggml-model-{f32,f16}.bin[.N]`` — one
output per checkpoint part, exactly like the reference (7B=1, 13B=2, 30B=4,
65B=8 parts, ``convert-pth-to-ggml.py:39-49, 79-91``).

Replicated behavior:

* vocab serialization rules (``:102-124``): unknown → " ⁇ ", control →
  empty, byte tokens → the raw byte, normal → piece with U+2581 → space;
* ``rope.freqs`` tensors skipped (``:130-131``);
* 2-D tensors stored f16 (unless ftype 0), 1-D always f32 (``:154-159``);
* record layout [n_dims][name_len][ftype][ne reversed][name][data]
  (``:162-169``).

sentencepiece is imported lazily, so the rest of the package does not need
it.
"""

from __future__ import annotations

import json
import os
import struct
import sys

import numpy as np
import torch

FTYPE_STR = ["f32", "f16"]


def get_n_parts(dim: int) -> int:
    """Checkpoint part count by embedding dim (``convert-pth-to-ggml.py:39-49``).
    Unknown dims (tiny test models) default to single-part with a warning
    instead of the reference's hard exit — real LLaMA dims hit the table."""
    table = {4096: 1, 5120: 2, 6656: 4, 8192: 8}
    if dim not in table:
        print(f"warning: unknown dim {dim}, assuming single-part checkpoint",
              file=sys.stderr)
        return 1
    return table[dim]


def write_vocab_from_sentencepiece(fout, tokenizer, n_vocab: int = 32000) -> None:
    for i in range(n_vocab):
        if tokenizer.is_unknown(i):
            text = " ⁇ ".encode("utf-8")
        elif tokenizer.is_control(i):
            text = b""
        elif tokenizer.is_byte(i):
            piece = tokenizer.id_to_piece(i)
            if len(piece) != 6:  # "<0xXX>"
                print(f"Invalid token: {piece}")
                sys.exit(1)
            text = bytes([int(piece[3:-1], 16)])
        else:
            text = tokenizer.id_to_piece(i).replace("▁", " ").encode("utf-8")
        fout.write(struct.pack("<i", len(text)))
        fout.write(text)


def convert(dir_model: str, ftype: int = 1) -> list[str]:
    from sentencepiece import SentencePieceProcessor  # lazy

    with open(os.path.join(dir_model, "params.json")) as f:
        hparams = json.load(f)
    tokenizer = SentencePieceProcessor(
        os.path.join(dir_model, "..", "tokenizer.model")
    )
    hparams["vocab_size"] = tokenizer.vocab_size()
    n_parts = get_n_parts(hparams["dim"])
    outputs = []

    for p in range(n_parts):
        fname_model = os.path.join(dir_model, f"consolidated.0{p}.pth")
        fname_out = os.path.join(
            dir_model, f"ggml-model-{FTYPE_STR[ftype]}.bin" + (f".{p}" if p else "")
        )
        model = torch.load(fname_model, map_location="cpu")
        with open(fname_out, "wb") as fout:
            fout.write(struct.pack("<i", 0x67676D6C))
            fout.write(struct.pack("<i", hparams["vocab_size"]))
            fout.write(struct.pack("<i", hparams["dim"]))
            fout.write(struct.pack("<i", hparams["multiple_of"]))
            fout.write(struct.pack("<i", hparams["n_heads"]))
            fout.write(struct.pack("<i", hparams["n_layers"]))
            fout.write(struct.pack("<i", hparams["dim"] // hparams["n_heads"]))
            fout.write(struct.pack("<i", ftype))
            # the reference hardcodes range(32000) here
            # (convert-pth-to-ggml.py:101 "Is this correct??"); use the real
            # vocab size so the header and vocab section always agree
            write_vocab_from_sentencepiece(fout, tokenizer, hparams["vocab_size"])

            for name, v in model.items():
                if name.endswith("freqs"):
                    continue
                data = v.to(torch.float32).numpy().squeeze()
                n_dims = len(data.shape)
                ftype_cur = 1
                if ftype == 0 or n_dims == 1:
                    data = data.astype(np.float32)
                    ftype_cur = 0
                else:
                    data = data.astype(np.float16)
                print(
                    f"Processing variable: {name} with shape: {data.shape} "
                    f"-> {FTYPE_STR[ftype_cur]}"
                )
                sname = name.encode("utf-8")
                fout.write(struct.pack("<iii", n_dims, len(sname), ftype_cur))
                for i in range(n_dims):
                    fout.write(struct.pack("<i", data.shape[n_dims - 1 - i]))
                fout.write(sname)
                data.tofile(fout)
        del model
        outputs.append(fname_out)
        print(f"Done. Output file: {fname_out}, (part {p})")
    return outputs


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 1:
        print("Usage: convert_pth.py dir-model [ftype]\n  ftype == 0 -> float32\n  ftype == 1 -> float16")
        return 1
    ftype = int(argv[1]) if len(argv) > 1 else 1
    if ftype not in (0, 1):
        print(f"Invalid ftype: {ftype}")
        return 1
    convert(argv[0], ftype)
    return 0


if __name__ == "__main__":
    sys.exit(main())
