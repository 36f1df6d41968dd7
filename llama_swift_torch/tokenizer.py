"""Greedy longest-match tokenizer, parity with the reference's
``llama_tokenize`` (``Sources/cpp/utils.cpp:275-311``).

The reference does NOT run real SentencePiece BPE (``utils.h:74-76`` admits
the approximation): at each position it scans the whole ``id_to_token`` map
(ascending id order) for the longest piece matching the remaining text.
Behavioral details we replicate exactly:

* match scoring ``kv.second.size() < l → skip`` means ties on length are won
  by the *largest id* (later map entries overwrite);
* BOS is the hardcoded id 1, prepended when requested (``utils.cpp:284-286``);
* at the first position where no piece matches, tokenization SILENTLY STOPS,
  discarding the rest of the input (``utils.cpp:302-304``);
* pieces are raw byte strings (byte-fallback tokens from the converter may be
  invalid UTF-8, ``convert-pth-to-ggml.py:113-118``); matching is on bytes;
* duplicate piece strings: the highest id wins (both for ``token_to_id``
  insertion order and the tokenize tie-break).

The O(len·V) scan is replaced by a hash map keyed on piece bytes holding the
max id, probed from the longest plausible length down — same output, O(len·L)
with L = longest piece.
"""

from __future__ import annotations

from typing import Iterable, Union

BOS_TOKEN_ID = 1  # hardcoded in the reference (utils.cpp:286)


class Vocab:
    """id ↔ byte-piece tables (``gpt_vocab``, ``utils.h:49-55``)."""

    def __init__(self, pieces: Iterable[bytes]):
        self.pieces: list[bytes] = [bytes(p) for p in pieces]
        # piece -> max id (later ids overwrite, matching std::map iteration +
        # equal-length overwrite semantics in llama_tokenize, and
        # token_to_id[word] = i insertion in the loader .mm:157-160)
        self.piece_to_id: dict[bytes, int] = {}
        for i, p in enumerate(self.pieces):
            if p:
                self.piece_to_id[p] = i
        self.max_piece_len = max((len(p) for p in self.pieces), default=0)

    def __len__(self) -> int:
        return len(self.pieces)

    # -- encode ----------------------------------------------------------

    def tokenize(self, text: Union[str, bytes], bos: bool = False) -> list[int]:
        data = text.encode("utf-8") if isinstance(text, str) else bytes(text)
        out: list[int] = []
        if bos:
            out.append(BOS_TOKEN_ID)
        pos = 0
        n = len(data)
        while pos < n:
            tid = -1
            for ln in range(min(self.max_piece_len, n - pos), 0, -1):
                cand = self.piece_to_id.get(data[pos : pos + ln])
                if cand is not None:
                    tid = cand
                    pos += ln
                    break
            if tid < 0:
                break  # reference: silently stop at first unmatched byte
            out.append(tid)
        return out

    # -- decode ----------------------------------------------------------

    def piece(self, token_id: int) -> bytes:
        return self.pieces[token_id]

    def piece_str(self, token_id: int) -> str:
        """Single-token text, as the event stream emits it
        (``LlamaPredictOperation.mm:892-895``).

        The reference builds an NSString per token from the raw bytes; invalid
        UTF-8 (split multibyte/byte-fallback tokens) yields nil there — we use
        errors='replace' instead of dropping (documented deviation).
        """
        return self.pieces[token_id].decode("utf-8", errors="replace")

    def detokenize(self, ids: Iterable[int]) -> str:
        """Concatenate pieces, decoding once at the end so multibyte UTF-8
        split across byte-fallback tokens reassembles correctly."""
        return b"".join(self.pieces[i] for i in ids).decode("utf-8", errors="replace")

    def detokenize_bytes(self, ids: Iterable[int]) -> bytes:
        return b"".join(self.pieces[i] for i in ids)
