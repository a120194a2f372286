"""A hermetic byte-level tokenizer (copy of `CharTokenizer` in
areal_tpu/data/tokenizer.py): encode/decode, eos/pad ids, vocab_size."""

from typing import List


class CharTokenizer:
    """Byte-level over UTF-8: ids 0..255 are bytes, then the specials."""

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
