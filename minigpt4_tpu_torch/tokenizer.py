"""LLaMA tokenizer compatible with llama.cpp's in-file vocab.

The reference tokenizes through ``llama_tokenize`` (llama.cpp at
master-31cfbb1; call site the reference's minigpt4.cpp:2384-2397, always with
``add_bos=true``).  That tokenizer is a greedy score-based bigram merger over
the vocab embedded in the model file.  Vocab entries are the SentencePiece
pieces with U+2581 ("▁") already replaced by a literal space at conversion
time, so both tokenization and detokenization operate on raw bytes.

Algorithm (llama.cpp ``llama_tokenizer``):
  1. split the input into UTF-8 characters (initial symbols);
  2. repeatedly merge the adjacent pair whose concatenation is a vocab token
     with the highest score (ties: leftmost);
  3. any leftover symbol not in the vocab is emitted as raw byte tokens
     (token id = byte value + 3).

Special ids: UNK=0, BOS=1, EOS=2.  ``id_to_token`` maps EOS to the literal
string "</s>" exactly like the reference (minigpt4.cpp:2485-2497).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

TOKEN_UNK = 0
TOKEN_BOS = 1
TOKEN_EOS = 2


def _utf8_split(data: bytes) -> list[bytes]:
    """Split bytes into UTF-8 character chunks (llama.cpp utf8_len table:
    invalid lead bytes are treated as single-byte symbols)."""
    lookup = (1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 3, 4)
    out = []
    i = 0
    n = len(data)
    while i < n:
        ln = lookup[data[i] >> 4]
        ln = min(ln, n - i)
        out.append(data[i : i + ln])
        i += ln
    return out


@dataclass
class _Symbol:
    text: bytes
    prev: int
    next: int


class LlamaTokenizer:
    def __init__(self, tokens: list[bytes], scores: list[float]):
        self.tokens = tokens
        self.scores = scores
        self.token_to_id: dict[bytes, int] = {}
        for i, t in enumerate(tokens):
            # first occurrence wins (matches unordered_map insert semantics)
            self.token_to_id.setdefault(t, i)

    @property
    def n_vocab(self) -> int:
        return len(self.tokens)

    def tokenize(self, text: str | bytes, add_bos: bool = True) -> list[int]:
        data = text.encode("utf-8") if isinstance(text, str) else bytes(text)
        out: list[int] = [TOKEN_BOS] if add_bos else []
        if not data:
            return out

        chunks = _utf8_split(data)
        syms = [
            _Symbol(c, i - 1, i + 1 if i + 1 < len(chunks) else -1)
            for i, c in enumerate(chunks)
        ]

        # priority queue of candidate merges: (-score, left_index, cached_texts)
        heap: list[tuple[float, int, bytes]] = []

        def try_add(left: int) -> None:
            if left == -1:
                return
            right = syms[left].next
            if right == -1:
                return
            cat = syms[left].text + syms[right].text
            tid = self.token_to_id.get(cat)
            if tid is not None:
                heapq.heappush(heap, (-self.scores[tid], left, cat))

        for i in range(len(syms) - 1):
            try_add(i)

        while heap:
            _, left, cat = heapq.heappop(heap)
            lsym = syms[left]
            if not lsym.text or lsym.next == -1:
                continue
            rsym = syms[lsym.next]
            if not rsym.text or lsym.text + rsym.text != cat:
                continue  # stale entry: one side was merged already
            lsym.text = cat
            rsym.text = b""
            lsym.next = rsym.next
            if rsym.next != -1:
                syms[rsym.next].prev = left
            try_add(lsym.prev)
            try_add(left)

        i = 0
        while i != -1:
            sym = syms[i]
            if sym.text:
                tid = self.token_to_id.get(sym.text)
                if tid is not None:
                    out.append(tid)
                else:
                    # fall back to byte tokens (id = byte + 3)
                    out.extend(b + 3 for b in sym.text)
            i = sym.next
        return out

    def id_to_bytes(self, token_id: int) -> bytes:
        return self.tokens[token_id]

    def id_to_str(self, token_id: int) -> str:
        """Token text as the reference's ``id_to_token`` returns it
        (EOS -> "</s>", minigpt4.cpp:2485-2497)."""
        if token_id == TOKEN_EOS:
            return "</s>"
        return self.tokens[token_id].decode("utf-8", errors="replace")

    def detokenize(self, ids: list[int]) -> str:
        return b"".join(self.tokens[i] for i in ids).decode("utf-8", errors="replace")
