"""Hermetic math answer verification (copy of
areal_tpu/interfaces/math_verify.py).

Grading: extract the last \\boxed{...} (or final-answer line) from the
generated text and compare it with each gold solution by normalized
string, by exact fraction, or by number within a relative 1e-4 (percent-
flexible); multiple-choice golds grade by letter extraction.  What that
cannot decide falls through to sympy equivalence (`math_sympy.py`).
"""

import re
from fractions import Fraction
from typing import List, Optional


def extract_boxed(text: str) -> Optional[str]:
    """Last \\boxed{...} content, handling nested braces."""
    idx = text.rfind("\\boxed{")
    if idx == -1:
        idx = text.rfind("\\fbox{")
        if idx == -1:
            return None
        start = idx + len("\\fbox{")
    else:
        start = idx + len("\\boxed{")
    depth = 1
    out = []
    for ch in text[start:]:
        if ch == "{":
            depth += 1
        elif ch == "}":
            depth -= 1
            if depth == 0:
                return "".join(out)
        out.append(ch)
    return None


def extract_answer(text: str) -> Optional[str]:
    boxed = extract_boxed(text)
    if boxed is not None:
        return boxed
    # "The answer is X" fallback (reference parser has the same heuristic).
    m = re.findall(
        r"(?:answer is|answer:)\s*([^\n\.,]+)", text, flags=re.IGNORECASE
    )
    if m:
        return m[-1].strip()
    return None


_STRIP_PATTERNS = [
    (re.compile(r"\\left|\\right"), ""),
    (re.compile(r"\\,|\\;|\\!|\\ |\s+"), ""),
    (re.compile(r"\\text\{[^}]*\}"), ""),
    (re.compile(r"\\mathrm\{[^}]*\}"), ""),
    (re.compile(r"^\$+|\$+$"), ""),
    (re.compile(r"\\%|%"), ""),
    (re.compile(r"^\{(.*)\}$"), r"\1"),
]


def normalize(ans: str) -> str:
    s = ans.strip()
    for pat, rep in _STRIP_PATTERNS:
        s = pat.sub(rep, s)
    s = s.rstrip(".")
    # \frac{a}{b} -> a/b
    s = re.sub(r"\\d?frac\{([^{}]+)\}\{([^{}]+)\}", r"\1/\2", s)
    s = re.sub(r"\\d?frac(\d)(\d)", r"\1/\2", s)
    return s


def _as_number(s: str) -> Optional[Fraction]:
    s = s.replace(",", "")
    try:
        return Fraction(s)
    except (ValueError, ZeroDivisionError):
        pass
    try:
        return Fraction(float(s)).limit_denominator(10**9)
    except (ValueError, OverflowError):
        return None


# A-E is the reference's range (grader.py:30); F-J extends it for
# 10-option sets (MMLU-Pro style), where the reference would crash.
CHOICE_LETTERS = "ABCDEFGHIJ"
_CHOICE_RE = re.compile(r"\b([A-J])\b")


_PAREN_CHOICE_RE = re.compile(r"\(([A-J])\)")


def choice_answer_clean(pred: str) -> str:
    """Multiple-choice extraction (reference: evaluation/grader.py:30 /
    parser.py:373 last-standalone-letter-wins, extended to A-J).
    POSITIONAL: the last letter in the text wins whether it is
    parenthesized or standalone — '(A) is wrong, the answer is B' must
    grade B (a paren-beats-standalone priority would grade A).  The
    English words 'A' and 'I' are ambiguous when bare (not
    parenthesized) and only count when no other candidate exists
    ('The answer is (B). I am sure.' must grade B, not I)."""
    pred = pred.strip("\n").rstrip(".").rstrip("/").strip(" ").lstrip(":")
    up = pred.upper()
    cands = [
        (m.start(1), m.group(1), True)
        for m in _PAREN_CHOICE_RE.finditer(up)
    ]
    taken = {p for p, _, _ in cands}
    cands += [
        (m.start(1), m.group(1), False)
        for m in _CHOICE_RE.finditer(up)
        if m.start(1) not in taken
    ]
    strong = [(p, c) for p, c, paren in cands if paren or c not in ("A", "I")]
    if strong:
        return max(strong)[1]
    if cands:
        return max(cands)[1]
    out = pred.strip().strip(".")
    return out.rstrip(".").rstrip("/")


def is_multi_choice(gold: str, is_choice: Optional[bool] = None) -> bool:
    """True when the gold should grade through choice extraction.

    `is_choice` is ROW-LEVEL evidence (the row carried a `choices`
    field, or its task tag marks it multiple-choice): True/False decide
    outright; None falls back to gold-string inference — one or more
    choice letters (GPQA/MMLU-style), e.g. 'B' or 'ACD' (reference:
    math_eval.py:369).  The inference alone misgrades math rows whose
    honest answer happens to be a letter string (a variable named 'C',
    interval endpoints 'AB'), so callers that know the row pass the
    evidence down (interfaces/reward.py, scheduler/evaluator.py)."""
    g = gold.strip()
    looks_like_letters = bool(g) and all(c in CHOICE_LETTERS for c in g)
    if is_choice is None:
        return looks_like_letters
    # Even with row evidence the gold must be letters — a choice row
    # whose gold is the option TEXT still grades as a plain answer.
    return bool(is_choice) and looks_like_letters


def choice_match(pred: str, gold: str) -> bool:
    gold = gold.strip()
    if len(gold) == 1:
        return choice_answer_clean(pred) == gold
    # Multi-letter golds: collect STANDALONE letters (word-boundary, like
    # the single-letter path) so prose ("the answers are A, C and D")
    # doesn't shed stray capitals into the comparison; a bare compact
    # answer ("ACD") has no \b-separated letters and falls back to the
    # reference's char filter over the extracted answer
    # (math_eval.py:596).
    # Order- and duplicate-insensitive: "the correct options are (C)
    # and (A)" must match gold "AC"; restating a letter must not break
    # the comparison.  Bare 'A'/'I' are ambiguous (English words), so
    # the prediction matches if ANY consistent reading — parenthesized
    # letters only, standalone letters without A/I, standalone letters
    # with them, or the reference's raw char filter — equals the gold
    # set.  (The reference's char filter alone has both failure modes;
    # trying each reading strictly dominates it.)
    up = pred.upper()
    want = "".join(sorted(set(gold)))
    readings = (
        _PAREN_CHOICE_RE.findall(up),
        [c for c in _CHOICE_RE.findall(up) if c not in ("A", "I")],
        _CHOICE_RE.findall(up),
        [c for c in up if c in CHOICE_LETTERS],
    )
    return any(
        r and "".join(sorted(set(r))) == want for r in readings
    )


def answers_match(pred: str, gold: str) -> bool:
    p, g = normalize(pred), normalize(gold)
    if p == g:
        return True
    pn, gn = _as_number(p), _as_number(g)
    if pn is not None and gn is not None:
        if pn == gn:
            return True
        # Reference numeric semantics (evaluation/grader.py:106,278):
        # percent-flexible (x matches x/100 and 100x) with rel_tol=1e-4.
        for cand in (gn, gn / 100, gn * 100):
            if abs(pn - cand) <= 1e-4 * max(abs(cand), 1e-12):
                return True
    return False


def verify_math(
    generated_text: str,
    solutions: List[str],
    use_sympy: bool = True,
    is_choice: Optional[bool] = None,
) -> bool:
    """True iff the generated answer matches any gold solution (each gold
    may itself be a \\boxed{...} wrapper or a raw answer).  The cheap
    string/Fraction path decides most cases; symbolically equivalent forms
    (intervals, matrices, radicals) fall through to the sympy grader with
    a hard per-call timeout."""
    pred = extract_answer(generated_text)
    golds = []
    for sol in solutions:
        gold = extract_boxed(sol)
        if gold is None:
            gold = sol
        # Multiple-choice golds grade through choice extraction; without
        # a boxed answer the last non-empty line stands in.
        if is_multi_choice(gold, is_choice):
            cand = pred
            if cand is None:
                lines = [
                    l for l in generated_text.strip().splitlines() if l.strip()
                ]
                cand = lines[-1] if lines else ""
            if choice_match(cand, gold):
                return True
            continue
        if pred is not None and answers_match(pred, gold):
            return True
        golds.append(gold)
    if pred is None:
        return False
    if use_sympy:
        from areal_tpu_torch.interfaces.math_sympy import answers_match_sympy

        for gold in golds:
            if answers_match_sympy(pred, gold):
                return True
    return False
