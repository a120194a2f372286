"""The port's `tokenizer.json` reader (`areal_tpu_torch/data/bpe.py`,
reached from `load_hf_tokenizer`) against the JAX package's
`load_hf_tokenizer` (transformers over the `tokenizers` library), on
byte-level BPEs trained here with `tokenizers` (no download):

- a qwen2 layout (NFC, qwen2's Split pattern, ByteLevel) and a llama-3
  layout (llama-3's pattern, `ignore_merges`, a BOS template), each with
  special tokens: ids (with and without special tokens), decodes (with
  and without skipping them, and of every prefix of the ids, which cuts
  UTF-8 sequences), `__call__` and the special ids equal, on a corpus of
  math rows, CJK, emoji, digit runs, whitespace and newline runs,
  contractions and special tokens inside text;
- merges written as "a b" strings read as the ["a", "b"] pairs;
- the pre-tokenizer scanner against the Split pattern run by
  `tokenizers` on random strings;
- `save_pretrained` round trips, and the file `chip_smoke.py`'s own
  trainer writes;
- in a subprocess where `transformers`, `tokenizers` and `regex` cannot
  be imported, the reader loads and encodes the same ids."""

import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest
from tokenizers import Regex, Tokenizer, decoders, models, normalizers, pre_tokenizers
from tokenizers import processors, trainers

import chip_smoke
from areal_tpu.data.tokenizer import load_hf_tokenizer as jload
from areal_tpu_torch.data.bpe import LLAMA3_PATTERN, QWEN2_PATTERN, BPETokenizer, split_words
from areal_tpu_torch.data.tokenizer import load_hf_tokenizer
from tests import fixtures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SPECIALS = {"qwen2": ["<|endoftext|>", "<|im_start|>", "<|im_end|>"],
            "llama3": ["<|begin_of_text|>", "<|end_of_text|>", "<|eot_id|>"]}


def _corpus():
    rows = fixtures.build_math_rows(16, seed=1)
    lines = [r["prompt"] for r in rows] + [s for r in rows for s in r["solutions"]]
    lines += [
        "数学问题：计算 123456789 的平方根，然后写出答案。",
        "東京タワーは333メートル。한국어 문장도 있습니다.",
        "emoji 😀👍🏽 family 👨‍👩‍👧 flags 🇯🇵 done",
        "digits 0 12 345 6789 1234567890 ٣٤٥ ² ½ 00007",
        "tabs\t\tand   spaces    end   ",
        "\n\n\nnewlines\r\n\r\nand\n \n  mixed\n\t\n",
        "don't won't can't I'M YOU'RE it'S we'LL they'D 'VE 'ſ",
        "Hello<|endoftext|>world<|im_start|>user\nhi<|im_end|>",
        "<|begin_of_text|>start<|end_of_text|> and <|eot_id|>",
        "x = 3.14159; y=2e10 ... ?!?!  (a+b)^2 = a^2 + 2ab + b^2",
        "Ünïcödé café naïve résumé Å Å",  # composed and decomposed forms
        "\\boxed{46} \\frac{1}{2} $x^2$",
        "   leading and trailing   ",
        "a\x1c\x1db\x85c d e　f",
        "",
    ]
    return lines


def _train(layout, path):
    """A small byte-level BPE in `layout`, trained here, written into
    `path` with its tokenizer_config.json."""
    tok = Tokenizer(models.BPE(ignore_merges=(layout == "llama3")))
    pattern = QWEN2_PATTERN if layout == "qwen2" else LLAMA3_PATTERN
    if layout == "qwen2":
        tok.normalizer = normalizers.NFC()
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(pattern), behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False),
    ])
    tok.decoder = decoders.ByteLevel()
    specials = SPECIALS[layout]
    trainer = trainers.BpeTrainer(vocab_size=700, special_tokens=specials, show_progress=False,
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(_corpus() * 10, trainer)
    if layout == "qwen2":
        tok.post_processor = processors.ByteLevel(trim_offsets=False)
        config = {"eos_token": specials[0], "pad_token": specials[0],
                  "clean_up_tokenization_spaces": False}
    else:
        bos = specials[0]
        tok.post_processor = processors.Sequence([
            processors.ByteLevel(trim_offsets=False),
            processors.TemplateProcessing(single=f"{bos} $A", pair=f"{bos} $A {bos} $B",
                                          special_tokens=[(bos, tok.token_to_id(bos))]),
        ])
        config = {"bos_token": bos, "eos_token": specials[1], "clean_up_tokenization_spaces": True}
    os.makedirs(path, exist_ok=True)
    tok.save(os.path.join(path, "tokenizer.json"))
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast", **config}, f)
    return str(path)


@pytest.fixture(scope="module", params=["qwen2", "llama3"])
def trained(request, tmp_path_factory):
    return request.param, _train(request.param, tmp_path_factory.mktemp(request.param))


def _assert_same(got, want, lines):
    assert isinstance(got, BPETokenizer)
    assert (got.eos_token_id, got.pad_token_id, got.bos_token_id) == (
        want.eos_token_id, want.pad_token_id, want.bos_token_id)
    assert got.vocab_size == want.vocab_size
    for text in lines:
        for add in (True, False):
            assert got.encode(text, add_special_tokens=add) == want.encode(
                text, add_special_tokens=add), (text, add)
        ids = want.encode(text)
        for skip in (False, True):
            assert got.decode(ids, skip_special_tokens=skip) == want.decode(
                ids, skip_special_tokens=skip), (text, skip)
        for cut in range(len(ids)):  # prefixes cut multi-byte characters
            assert got.decode(ids[:cut]) == want.decode(ids[:cut]), (text, cut)
    assert got.encode(lines[0]) == want.encode(lines[0])  # the default: add specials
    got_call, want_call = got(lines), want(lines)
    assert got_call["input_ids"] == want_call["input_ids"]
    assert got_call["attention_mask"] == want_call["attention_mask"]
    assert got(lines[1])["input_ids"] == want(lines[1])["input_ids"]
    for n in (1, 3, 8):  # truncation keeps room for the template's special tokens
        assert got(lines, truncation=True, max_length=n)["input_ids"] == want(
            lines, truncation=True, max_length=n)["input_ids"], n


def test_ids_and_decodes_equal_transformers(trained):
    _, path = trained
    _assert_same(load_hf_tokenizer(path), jload(path), _corpus())


def test_merges_as_strings(trained, tmp_path):
    """The older files write each merge as "a b"; the reader takes both
    forms."""
    _, path = trained
    with open(os.path.join(path, "tokenizer.json")) as f:
        spec = json.load(f)
    spec["model"]["merges"] = [" ".join(m) for m in spec["model"]["merges"]]
    for name in ("tokenizer_config.json",):
        with open(os.path.join(path, name)) as src, open(tmp_path / name, "w") as dst:
            dst.write(src.read())
    with open(tmp_path / "tokenizer.json", "w") as f:
        json.dump(spec, f)
    got, want = load_hf_tokenizer(str(tmp_path)), load_hf_tokenizer(path)
    for text in _corpus():
        assert got.encode(text) == want.encode(text), text


@pytest.mark.parametrize("pattern", [QWEN2_PATTERN, LLAMA3_PATTERN], ids=["qwen2", "llama3"])
def test_split_words_matches_the_pattern(pattern):
    """The scanner against the Split pattern as `tokenizers` runs it
    (Oniguruma), on 400 seeded random strings over letters of several
    scripts, digits (ASCII, Arabic-Indic, superscript, fractions),
    combining marks, apostrophes, whitespace of every kind and
    punctuation."""
    pre = pre_tokenizers.Split(Regex(pattern), behavior="isolated", invert=False)
    max_digits = 1 if pattern == QWEN2_PATTERN else 3
    pool = ("abcXYZ\xe9\xdf\u017f\u6578\u5b66\u30ab\ud55c"  # letters of five scripts
            "0123456789\u0663\u0664\xb2\xbd"  # digits: ASCII, Arabic-Indic, No
            "\u0301\u0308'`"  # combining marks, apostrophes
            " \t\n\r\x0b\x0c\x1c\x1f\x85\xa0\u2028\u3000"  # whitespace, and not
            ".,!?;:-+=()[]{}\\$#@\U0001f600\U0001f44d")
    rng = random.Random(0)
    for _ in range(400):
        text = "".join(rng.choice(pool) for _ in range(rng.randint(1, 40)))
        want = [piece for piece, _ in pre.pre_tokenize_str(text)]
        assert split_words(text, max_digits) == want, repr(text)


def test_save_pretrained_round_trip(trained, tmp_path):
    """What the reader saves (a checkpoint's tokenizer files) loads back
    in both packages to the same tokenizer."""
    _, path = trained
    load_hf_tokenizer(path).save_pretrained(str(tmp_path))
    _assert_same(load_hf_tokenizer(str(tmp_path)), jload(str(tmp_path)), _corpus())


def test_chip_smoke_trainer_file(tmp_path):
    """The tokenizer.json that chip_smoke.py trains and writes for its
    trainmodes phase (the card has no `tokenizers`) reads the same in
    both packages."""
    rows = chip_smoke._math_rows(np.random.default_rng(5), 32)  # the phase's own rows
    n_vocab, n_merges = chip_smoke.train_bpe_tokenizer(
        [r["prompt"] for r in rows] + [s for r in rows for s in r["solutions"]], str(tmp_path))
    assert n_merges > 50 and n_vocab == 256 + n_merges
    got, want = load_hf_tokenizer(str(tmp_path)), jload(str(tmp_path))
    _assert_same(got, want, _corpus() + [r["prompt"] for r in rows])
    assert got.eos_token_id == n_vocab  # the first special token after the vocab


def test_loads_without_hf_packages(trained):
    """A fresh interpreter where `transformers`, `tokenizers`, `regex`,
    `jax` and the JAX package cannot be imported loads the file and
    encodes the corpus to the same ids."""
    _, path = trained
    code = (
        "import json, sys\n"
        "for m in ('transformers', 'tokenizers', 'regex', 'jax', 'areal_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from areal_tpu_torch.data.tokenizer import load_hf_tokenizer\n"
        f"tok = load_hf_tokenizer({path!r})\n"
        "lines = json.loads(sys.stdin.read())\n"
        "print(json.dumps([tok.encode(t) for t in lines]))\n"
    )
    lines = _corpus()
    out = subprocess.run([sys.executable, "-c", code], input=json.dumps(lines), text=True,
                         capture_output=True, timeout=120, check=True)
    want = load_hf_tokenizer(path)
    assert json.loads(out.stdout) == [want.encode(t) for t in lines]


def test_other_layouts_go_to_transformers(tmp_path):
    """A tokenizer.json of another family (WordPiece) loads through
    transformers, as before; a byte-level BPE feature the reader does not
    have is refused, not approximated."""
    wp = Tokenizer(models.WordPiece({"[UNK]": 0, "a": 1, "b": 2}, unk_token="[UNK]"))
    wp.pre_tokenizer = pre_tokenizers.Whitespace()
    wp.save(str(tmp_path / "tokenizer.json"))
    with open(tmp_path / "tokenizer_config.json", "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast", "eos_token": "[UNK]"}, f)
    tok = load_hf_tokenizer(str(tmp_path))
    assert not isinstance(tok, BPETokenizer) and tok.encode("a b") == [1, 2]
    spec = json.loads(open(_train("qwen2", str(tmp_path / "q")) + "/tokenizer.json").read())
    spec["added_tokens"][0]["lstrip"] = True
    with pytest.raises(NotImplementedError, match="lstrip"):
        BPETokenizer(spec)
