"""Tokenizer loading (port of areal_tpu/data/tokenizer.py).

`load_hf_tokenizer("char:<n>")` gives the hermetic byte-level
`CharTokenizer` (needs nothing installed); any other path loads a
HuggingFace tokenizer through `transformers`, imported only then."""

from typing import List


def load_hf_tokenizer(path: str):
    if path.startswith("char:"):
        return CharTokenizer(vocab_size=int(path.split(":", 1)[1]))
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise RuntimeError(
            f"loading the tokenizer at {path!r} needs the `transformers` package, "
            "which is not installed; pass a 'char:<vocab_size>' tokenizer path "
            "for the byte-level tokenizer"
        ) from e
    tok = AutoTokenizer.from_pretrained(path, use_fast=True)
    if tok.pad_token_id is None:
        tok.pad_token = tok.eos_token
    return tok


class CharTokenizer:
    """Byte-level over UTF-8: ids 0..255 are bytes, then the specials
    (a copy of `CharTokenizer` in areal_tpu/data/tokenizer.py)."""

    def __init__(self, vocab_size: int = 512):
        self._byte_vocab = 256
        self.pad_token_id = 256
        self.eos_token_id = 257
        self.bos_token_id = 258
        self.vocab_size = max(vocab_size, 259)
        self.eos_token = "<eos>"
        self.pad_token = "<pad>"

    def encode(self, text: str, add_eos: bool = False) -> List[int]:
        ids = list(text.encode("utf-8"))
        if add_eos:
            ids.append(self.eos_token_id)
        return ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        bs = bytes(i for i in ids if 0 <= int(i) < self._byte_vocab)
        return bs.decode("utf-8", errors="replace")

    def __call__(self, texts, truncation=False, max_length=None, **kw):
        if isinstance(texts, str):
            texts = [texts]
        out = []
        for t in texts:
            ids = self.encode(t)
            if truncation and max_length is not None:
                ids = ids[:max_length]
            out.append(ids)
        return {"input_ids": out, "length": [len(x) for x in out]}
