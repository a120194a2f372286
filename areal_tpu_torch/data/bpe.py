"""A reader for HuggingFace `tokenizer.json` files of byte-level BPE, the
layout of qwen2 and llama-3 checkpoints, in plain Python.

It imports neither `transformers`, `tokenizers` nor `regex`, so a
checkpoint's own tokenizer runs where those packages are missing (the
CUDA card's machine).  `load_hf_tokenizer` (`data/tokenizer.py`) takes
it for every directory whose `tokenizer.json` has this layout.  What it
reads, and refuses anything else of:

- `model`: BPE with `vocab`, `merges` (as "a b" strings or ["a", "b"]
  pairs), `ignore_merges` (llama-3: a pre-token that is itself in the
  vocab is one id), no dropout, no unk token, no byte fallback, no
  subword prefix or suffix;
- `added_tokens` with their `special` and `normalized` flags (no
  `single_word`, `lstrip` or `rstrip`);
- `normalizer`: NFC (qwen2) or none (llama-3);
- `pre_tokenizer`: `Split` on qwen2's or llama-3's pattern (Isolated)
  then `ByteLevel(use_regex=false)`.  Python's `re` has no `\\p{L}` or
  `\\p{N}`, so the pattern runs as a scanner over
  `unicodedata.category` (`split_words`), with Oniguruma's `\\s`;
- `post_processor`: ByteLevel, `TemplateProcessing` (llama-3's BOS), or a
  `Sequence` of them;
- `decoder`: ByteLevel;
- from `tokenizer_config.json` (then `special_tokens_map.json`):
  `eos_token`, `pad_token`, `bos_token` and
  `clean_up_tokenization_spaces`.

It answers the calls the port makes of a tokenizer, as `transformers`'
fast tokenizer answers them: `encode(text, add_special_tokens=True)`,
`decode(ids, skip_special_tokens=False)`, `__call__`, `eos_token_id`,
`pad_token_id` (the eos when the config names no pad), `bos_token_id`,
`vocab_size` (the BPE vocab without the added tokens) and
`save_pretrained`.
"""

import json
import os
import unicodedata
from typing import Any, Dict, List, Optional, Sequence, Tuple

# The two Split patterns this reader runs (qwen2's, llama-3's): they
# differ only in how many digits one pre-token takes.
QWEN2_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*"
    r"|\s*[\r\n]+|\s+(?!\S)|\s+"
)
LLAMA3_PATTERN = QWEN2_PATTERN.replace(r"|\p{N}|", r"|\p{N}{1,3}|")
_MAX_DIGITS = {QWEN2_PATTERN: 1, LLAMA3_PATTERN: 3}

_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte -> printable character table (ByteLevel's alphabet)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


BYTE_TO_CHAR = _bytes_to_unicode()
CHAR_TO_BYTE = {c: b for b, c in BYTE_TO_CHAR.items()}


def _letter(c: str) -> bool:  # \p{L}
    return unicodedata.category(c)[0] == "L"


def _number(c: str) -> bool:  # \p{N}
    return unicodedata.category(c)[0] == "N"


def _space(c: str) -> bool:
    """Oniguruma's Unicode `\\s`: U+0009-000D, U+0085 and the Zs, Zl, Zp
    categories (Python's `\\s` also takes U+001C-001F)."""
    return c in "\t\n\v\f\r\x85" or unicodedata.category(c) in ("Zs", "Zl", "Zp")


def _other(c: str) -> bool:  # [^\s\p{L}\p{N}]
    return not (_space(c) or _letter(c) or _number(c))


def _run(text: str, i: int, pred) -> int:
    """The end of the run of characters from i that satisfy pred."""
    while i < len(text) and pred(text[i]):
        i += 1
    return i


def _match_end(text: str, i: int, max_digits: int) -> int:
    """The end of the pattern's match at position i: its alternatives in
    order, each with the regex engine's greedy backtracking."""
    n, c = len(text), text[i]
    # (?i:'s|'t|'re|'ve|'m|'ll|'d)
    if c == "'":
        for suffix in _CONTRACTIONS:
            seg = text[i + 1:i + 1 + len(suffix)]
            if len(seg) == len(suffix) and all(a.casefold() == b for a, b in zip(seg, suffix)):
                return i + 1 + len(suffix)
    # [^\r\n\p{L}\p{N}]?\p{L}+
    k = i + 1 if (c not in "\r\n" and not _letter(c) and not _number(c)) else i
    if k < n and _letter(text[k]):
        return _run(text, k, _letter)
    # \p{N} (qwen2) or \p{N}{1,3} (llama-3)
    if _number(c):
        j = i + 1
        while j < n and j - i < max_digits and _number(text[j]):
            j += 1
        return j
    # ' ?[^\s\p{L}\p{N}]+[\r\n]*'
    k = i + 1 if c == " " and i + 1 < n and _other(text[i + 1]) else i
    if _other(text[k]):
        return _run(text, _run(text, k, _other), lambda x: x in "\r\n")
    # Whitespace from here on: \s*[\r\n]+ | \s+(?!\S) | \s+
    j = _run(text, i, _space)
    for m in range(j - 1, i - 1, -1):
        if text[m] in "\r\n":  # \s* backs off to the run's last line break
            return m + 1
    if j == n:
        return j
    if j - i >= 2:  # \s+ backs off one so that (?!\S) holds
        return j - 1
    return j


def split_words(text: str, max_digits: int = 1) -> List[str]:
    """The pre-tokens of the Split pattern (Isolated): every position
    starts a match, so the pieces are the matches in order."""
    words, i = [], 0
    while i < len(text):
        j = _match_end(text, i, max_digits)
        words.append(text[i:j])
        i = j
    return words


def _content(tok) -> Optional[str]:
    """A special token as tokenizer_config.json spells it: a string or
    an AddedToken dict."""
    return tok.get("content") if isinstance(tok, dict) else tok


def _refuse(what: str):
    raise NotImplementedError(f"tokenizer.json: {what} is not read by the port's BPE reader")


class BPETokenizer:
    """A byte-level BPE tokenizer from a `tokenizer.json` (and its
    `tokenizer_config.json`); see the module docstring for the layout."""

    def __init__(self, spec: Dict[str, Any], config: Optional[Dict[str, Any]] = None):
        self._spec = spec
        self._config = dict(config or {})
        model = spec.get("model") or {}
        if model.get("type") != "BPE":
            _refuse(f"model type {model.get('type')!r}")
        for key, off in (("dropout", None), ("unk_token", None), ("byte_fallback", False),
                         ("continuing_subword_prefix", ""), ("end_of_word_suffix", "")):
            if model.get(key) not in (off, None):
                _refuse(f"model.{key}={model.get(key)!r}")
        self._vocab: Dict[str, int] = dict(model["vocab"])
        self._id_to_token = {i: t for t, i in self._vocab.items()}
        self._ignore_merges = bool(model.get("ignore_merges", False))
        self._ranks: Dict[Tuple[str, str], int] = {}
        for rank, m in enumerate(model.get("merges", [])):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            self._ranks.setdefault((a, b), rank)

        self._added: Dict[str, int] = {}
        self._added_by_id: Dict[int, str] = {}
        self._special = set()
        raw, normalized = [], []
        for tok in spec.get("added_tokens") or []:
            for flag in ("single_word", "lstrip", "rstrip"):
                if tok.get(flag):
                    _refuse(f"added token {tok['content']!r} with {flag}")
            self._added[tok["content"]] = tok["id"]
            self._added_by_id[tok["id"]] = tok["content"]
            if tok.get("special"):
                self._special.add(tok["content"])
            (normalized if tok.get("normalized") else raw).append(tok["content"])
        self._raw_added = sorted(raw, key=len, reverse=True)
        self._normalized_added = sorted(normalized, key=len, reverse=True)

        norm = spec.get("normalizer")
        if norm is not None and norm.get("type") != "NFC":
            _refuse(f"normalizer {norm.get('type')!r}")
        self._nfc = norm is not None
        self._max_digits = self._read_pre_tokenizer(spec.get("pre_tokenizer"))
        self._template = self._read_post_processor(spec.get("post_processor"))
        dec = spec.get("decoder")
        if dec is None or dec.get("type") != "ByteLevel":
            _refuse(f"decoder {None if dec is None else dec.get('type')!r}")

        cfg = self._config
        self.eos_token = _content(cfg.get("eos_token"))
        self.bos_token = _content(cfg.get("bos_token"))
        self.pad_token = _content(cfg.get("pad_token")) or self.eos_token
        self.clean_up_tokenization_spaces = bool(cfg.get("clean_up_tokenization_spaces", False))
        self._cache: Dict[str, List[int]] = {}

    # ---------------- layout ----------------

    @staticmethod
    def _read_pre_tokenizer(pre) -> int:
        steps = pre.get("pretokenizers", []) if pre and pre.get("type") == "Sequence" else [pre]
        if len(steps) != 2 or steps[0] is None or steps[0].get("type") != "Split":
            _refuse("a pre_tokenizer other than Split then ByteLevel")
        split, byte_level = steps
        pattern = (split.get("pattern") or {}).get("Regex")
        if pattern not in _MAX_DIGITS:
            _refuse(f"Split pattern {pattern!r}")
        if split.get("behavior") != "Isolated" or split.get("invert"):
            _refuse(f"Split behavior {split.get('behavior')!r} (invert={split.get('invert')})")
        if (byte_level.get("type") != "ByteLevel" or byte_level.get("use_regex")
                or byte_level.get("add_prefix_space")):
            _refuse("a ByteLevel pre_tokenizer with its own regex or a prefix space")
        return _MAX_DIGITS[pattern]

    @staticmethod
    def _read_post_processor(post) -> Optional[List[Any]]:
        """The single-sequence template, as [special token ids | None for
        the sequence], or None (no ids added)."""
        steps = post.get("processors", []) if post and post.get("type") == "Sequence" else [post]
        template = None
        for step in steps:
            if step is None or step.get("type") == "ByteLevel":
                continue
            if step.get("type") != "TemplateProcessing":
                _refuse(f"post_processor {step.get('type')!r}")
            specials = step.get("special_tokens", {})
            template = []
            for piece in step["single"]:
                if "Sequence" in piece:
                    template.append(None)
                else:
                    template.extend(specials[piece["SpecialToken"]["id"]]["ids"])
        return template

    # ---------------- encode ----------------

    def _split_added(self, pieces: List[Tuple[str, bool]], added: Sequence[str]):
        """Split the not-yet-matched pieces on the added tokens: at each
        position the earliest match, the longest at that position."""
        if not added:
            return pieces
        out = []
        for text, is_added in pieces:
            if is_added:
                out.append((text, True))
                continue
            i = start = 0
            while i < len(text):
                tok = next((t for t in added if text.startswith(t, i)), None)
                if tok is None:
                    i += 1
                    continue
                if i > start:
                    out.append((text[start:i], False))
                out.append((tok, True))
                i = start = i + len(tok)
            if start < len(text):
                out.append((text[start:], False))
        return out

    def _bpe(self, word: str) -> List[int]:
        """A pre-token's ids: the merges applied lowest rank first, the
        leftmost of equal ranks first.  A character outside the vocab is
        dropped (there is no unk token)."""
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        if self._ignore_merges and word in self._vocab:
            ids = [self._vocab[word]]
        else:
            syms = [ch for ch in word if ch in self._vocab]
            while len(syms) > 1:
                best, at = None, -1
                for k in range(len(syms) - 1):
                    r = self._ranks.get((syms[k], syms[k + 1]))
                    if r is not None and (best is None or r < best):
                        best, at = r, k
                if best is None:
                    break
                syms[at:at + 2] = [syms[at] + syms[at + 1]]
            ids = [self._vocab[s] for s in syms]
        self._cache[word] = ids
        return ids

    def _encode_plain(self, text: str) -> List[int]:
        ids = []
        for word in split_words(text, self._max_digits):
            ids.extend(self._bpe("".join(BYTE_TO_CHAR[b] for b in word.encode("utf-8"))))
        return ids

    def encode(self, text: str, add_special_tokens: bool = True, truncation: bool = False,
               max_length: Optional[int] = None) -> List[int]:
        pieces = self._split_added([(text, False)], self._raw_added)
        if self._nfc:
            pieces = [(t if a else unicodedata.normalize("NFC", t), a) for t, a in pieces]
        pieces = self._split_added(pieces, self._normalized_added)
        ids: List[int] = []
        for t, is_added in pieces:
            ids.extend([self._added[t]] if is_added else self._encode_plain(t))
        template = self._template if add_special_tokens else None
        if truncation and max_length is not None:
            n_special = len(template) - 1 if template else 0
            ids = ids[:max(max_length - n_special, 0)]
        if template:
            ids = [x for piece in template for x in (ids if piece is None else [piece])]
        return ids

    def __call__(self, text, add_special_tokens: bool = True, truncation: bool = False,
                 max_length: Optional[int] = None, **_):
        """{"input_ids", "attention_mask"} of a text, or of each text of
        a list."""
        if isinstance(text, str):
            ids = self.encode(text, add_special_tokens, truncation, max_length)
            return {"input_ids": ids, "attention_mask": [1] * len(ids)}
        ids = [self.encode(t, add_special_tokens, truncation, max_length) for t in text]
        return {"input_ids": ids, "attention_mask": [[1] * len(x) for x in ids]}

    # ---------------- decode ----------------

    def decode(self, ids, skip_special_tokens: bool = False,
               clean_up_tokenization_spaces: Optional[bool] = None) -> str:
        """Tokens to bytes through the ByteLevel alphabet (a token with a
        character outside it gives its own UTF-8), bytes to text with
        invalid sequences replaced; ids outside the vocab are dropped."""
        if isinstance(ids, int):
            ids = [ids]
        data = bytearray()
        for i in ids:
            tok = self._added_by_id.get(int(i), self._id_to_token.get(int(i)))
            if tok is None or (skip_special_tokens and tok in self._special):
                continue
            bs = [CHAR_TO_BYTE.get(ch) for ch in tok]
            data += tok.encode("utf-8") if None in bs else bytes(bs)
        text = data.decode("utf-8", errors="replace")
        clean = (self.clean_up_tokenization_spaces if clean_up_tokenization_spaces is None
                 else clean_up_tokenization_spaces)
        if clean:
            for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
                         (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"),
                         (" 're", "'re")):
                text = text.replace(a, b)
        return text

    # ---------------- vocab ----------------

    def token_to_id(self, token: Optional[str]) -> Optional[int]:
        if token is None:
            return None
        return self._added.get(token, self._vocab.get(token))

    @property
    def eos_token_id(self) -> Optional[int]:
        return self.token_to_id(self.eos_token)

    @property
    def bos_token_id(self) -> Optional[int]:
        return self.token_to_id(self.bos_token)

    @property
    def pad_token_id(self) -> Optional[int]:
        return self.token_to_id(self.pad_token)

    @property
    def vocab_size(self) -> int:
        return len(self._vocab)

    # ---------------- files ----------------

    @classmethod
    def from_pretrained(cls, path: str, spec: Optional[Dict[str, Any]] = None) -> "BPETokenizer":
        """Read `path`'s tokenizer.json (or take it parsed, `spec`) and
        its special tokens."""
        if spec is None:
            with open(os.path.join(path, "tokenizer.json"), encoding="utf-8") as f:
                spec = json.load(f)
        config: Dict[str, Any] = {}
        for name in ("special_tokens_map.json", "tokenizer_config.json"):
            p = os.path.join(path, name)
            if os.path.isfile(p):
                with open(p, encoding="utf-8") as f:
                    config.update(json.load(f))  # the config wins
        return cls(spec, config)

    def save_pretrained(self, path: str) -> Tuple[str, str]:
        """Write tokenizer.json and tokenizer_config.json into `path`."""
        os.makedirs(path, exist_ok=True)
        out = (os.path.join(path, "tokenizer.json"), os.path.join(path, "tokenizer_config.json"))
        config = {**self._config, "eos_token": self.eos_token, "bos_token": self.bos_token,
                  "pad_token": self.pad_token,
                  "clean_up_tokenization_spaces": self.clean_up_tokenization_spaces}
        for file, obj in zip(out, (self._spec, config)):
            with open(file, "w", encoding="utf-8") as f:
                json.dump(obj, f, ensure_ascii=False)
        return out


def is_byte_level_bpe(spec: Dict[str, Any]) -> bool:
    """Whether a parsed tokenizer.json is a byte-level BPE (a ByteLevel
    decoder over a BPE model), the family this reader serves."""
    return ((spec.get("model") or {}).get("type") == "BPE"
            and (spec.get("decoder") or {}).get("type") == "ByteLevel")
