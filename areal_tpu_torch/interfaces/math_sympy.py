"""Sympy-grade math answer equivalence (copy of
areal_tpu/interfaces/math_sympy.py).

Symbolic equality between a predicted and a gold answer written in
LaTeX: fractions vs decimals, radicals, intervals, finite sets, tuples,
matrices, simple equations.  A brace-aware LaTeX -> sympy translator plus
a structural comparator, run in a worker process with a hard timeout
because `sympy.simplify` can hang on adversarial inputs.
"""

import re
from typing import List, Optional, Tuple

# ---------------- LaTeX -> sympy-parseable text ----------------


def _match_brace(s: str, start: int) -> int:
    """Index just past the brace group opening at s[start] == '{'."""
    depth = 0
    for i in range(start, len(s)):
        if s[i] == "{":
            depth += 1
        elif s[i] == "}":
            depth -= 1
            if depth == 0:
                return i + 1
    return len(s)


def _take_group(s: str, i: int) -> Tuple[str, int]:
    """Read one latex argument at position i: {..}, a digit, or a token."""
    while i < len(s) and s[i] in " \t":
        i += 1
    if i >= len(s):
        return "", i
    if s[i] == "{":
        end = _match_brace(s, i)
        return s[i + 1 : end - 1], end
    if s[i] == "\\":  # a command token like \pi
        m = re.match(r"\\[a-zA-Z]+", s[i:])
        if m:
            return m.group(0), i + m.end()
    return s[i], i + 1


def _rewrite_frac(s: str) -> str:
    out = []
    i = 0
    while i < len(s):
        m = re.match(r"\\[dt]?frac", s[i:])
        if m:
            num, j = _take_group(s, i + m.end())
            den, j = _take_group(s, j)
            out.append(f"(({_rewrite_frac(num)})/({_rewrite_frac(den)}))")
            i = j
        else:
            out.append(s[i])
            i += 1
    return "".join(out)


def _rewrite_sqrt(s: str) -> str:
    out = []
    i = 0
    while i < len(s):
        if s.startswith("\\sqrt", i):
            j = i + len("\\sqrt")
            order = None
            if j < len(s) and s[j] == "[":
                k = s.index("]", j)
                order = s[j + 1 : k]
                j = k + 1
            arg, j = _take_group(s, j)
            arg = _rewrite_sqrt(arg)
            if order:
                out.append(f"(({arg})**(1/({order})))")
            else:
                out.append(f"(sqrt({arg}))")
            i = j
        else:
            out.append(s[i])
            i += 1
    return "".join(out)


_SIMPLE_SUBS = [
    (re.compile(r"\\left|\\right|\\limits"), ""),
    (re.compile(r"\\(?:,|;|!|:|\s)"), " "),
    (re.compile(r"\\text\s*\{[^{}]*\}"), ""),
    (re.compile(r"\\(?:mathrm|mathbf|mathit|operatorname)\s*\{([^{}]*)\}"), r"\1"),
    (re.compile(r"\\(?:cdot|times)"), "*"),
    (re.compile(r"\\div"), "/"),
    (re.compile(r"\\pi\b"), " pi "),
    (re.compile(r"\\infty\b"), " oo "),
    (re.compile(r"\\circ\b"), ""),  # degrees marker (with ^ stripped below)
    (re.compile(r"(?:\^\s*)(?=\s|$|[+\-*/,)\]])"), ""),  # dangling ^ from ^\circ
    (re.compile(r"\\%|%"), ""),
    (re.compile(r"\\(?:log|ln)\b"), " log"),
    (re.compile(r"\\(sin|cos|tan|cot|sec|csc|exp|sinh|cosh|tanh)\b"), r" \1"),
    (re.compile(r"\$"), ""),
    (re.compile(r"\\degree"), ""),
]


def latex_to_expr(ans: str) -> str:
    """Best-effort LaTeX -> a string `sympy.parse_expr` understands."""
    s = ans.strip()
    s = _rewrite_frac(s)
    s = _rewrite_sqrt(s)
    for pat, rep in _SIMPLE_SUBS:
        s = pat.sub(rep, s)
    # Mixed numbers: 1((1)/(2)) means 1 + 1/2 when both parts are numeric.
    s = re.sub(r"(\d)\s*\(\((\d+)\)/\((\d+)\)\)", r"(\1+(\2)/(\3))", s)
    s = s.replace("^", "**")
    s = re.sub(r"(\d)\{,\}(?=\d{3})", r"\1", s)  # 1{,}000 thousands braces
    # Remaining (non-set) braces are latex grouping: {x} -> (x).
    s = s.replace("{", "(").replace("}", ")")
    s = s.replace("°", "")
    s = re.sub(r"(\d),(?=\d{3}\b)", r"\1", s)  # thousands separators
    return s.strip()


# ---------------- structured answers ----------------


def _split_top(s: str, sep: str = ",") -> List[str]:
    parts, depth, cur = [], 0, []
    for ch in s:
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        if ch == sep and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return parts


_MATRIX_RE = re.compile(
    r"\\begin\{[pbvV]?matrix\}(.*?)\\end\{[pbvV]?matrix\}", re.DOTALL
)


def _parse_structure(ans: str):
    """Classify an answer: ('matrix', rows) | ('set', elems) |
    ('intervals', [(lb, lo, hi, rb), ...]) | ('tuple', elems) |
    ('expr', text)."""
    s = ans.strip()
    m = _MATRIX_RE.search(s)
    if m:
        rows = [
            [c.strip() for c in row.split("&")]
            for row in re.split(r"\\\\", m.group(1))
            if row.strip()
        ]
        return ("matrix", rows)
    if s.startswith("\\{") and s.endswith("\\}"):
        return ("set", _split_top(s[2:-2]))
    # Interval or union of intervals: (a,b] \cup [c,d) ...
    pieces = re.split(r"\\cup", s)
    ivs = []
    for p in pieces:
        p = re.sub(r"\\left|\\right", "", p).strip()
        if (
            len(p) >= 2
            and p[0] in "([" and p[-1] in ")]"
            and len(_split_top(p[1:-1])) == 2
        ):
            lo, hi = _split_top(p[1:-1])
            ivs.append((p[0], lo, hi, p[-1]))
        else:
            ivs = None
            break
    if ivs is not None and len(ivs) >= 1:
        if len(ivs) > 1:
            return ("intervals", ivs)
        # A single (a,b): ambiguous — tuple/point vs open interval; compare
        # as an ordered pair either way (bracket kinds checked separately).
        return ("intervals", ivs)
    return ("expr", s)


# ---------------- the in-process worker ----------------


def _parse(s: str):
    import sympy
    from sympy.parsing.sympy_parser import (
        implicit_multiplication_application,
        parse_expr,
        standard_transformations,
    )

    txt = latex_to_expr(s)
    # Single-variable equation: grade the rhs (e.g. "x = 5" vs "5").
    if txt.count("=") == 1:
        lhs, rhs = txt.split("=")
        if re.fullmatch(r"\s*[a-zA-Z]\w*\s*", lhs):
            txt = rhs
    expr = parse_expr(
        txt,
        transformations=standard_transformations
        + (implicit_multiplication_application,),
        evaluate=True,
    )
    # Grading convention: a bare `e` is Euler's number.
    return expr.subs(sympy.Symbol("e"), sympy.E)


def _exprs_equal(a: str, b: str) -> bool:
    import sympy

    ta, tb = latex_to_expr(a), latex_to_expr(b)
    # General equations (lhs = rhs on both sides): compare the zero-forms
    # up to overall sign — "-34x-45y+20z-100=0" must equal
    # "34x+45y-20z+100=0" (reference: grader.py:312 compares
    # |lhs-rhs| symbolically).
    if ta.count("=") == 1 and tb.count("=") == 1:
        da = _parse_equation_diff(ta)
        db = _parse_equation_diff(tb)
        if da is not None and db is not None:
            return bool(
                sympy.simplify(da - db) == 0
                or sympy.simplify(da + db) == 0
            )

    ea, eb = _parse(a), _parse(b)
    if ea == eb:
        return True
    diff = sympy.simplify(ea - eb)
    if diff == 0:
        return True
    try:
        if abs(complex(sympy.N(diff, 15))) < 1e-9:
            return True
    except (TypeError, ValueError):
        pass
    # Pure numbers: the reference grades digit pairs with rel_tol=1e-4
    # (grader.py:278) — "2.6667" equals 8/3.
    if not ea.free_symbols and not eb.free_symbols:
        try:
            fa, fb = complex(sympy.N(ea, 15)), complex(sympy.N(eb, 15))
            if abs(fa - fb) <= 1e-4 * max(abs(fb), 1e-12):
                return True
        except (TypeError, ValueError):
            pass
    res = ea.equals(eb)
    return bool(res)


def _parse_equation_diff(txt: str):
    """lhs-rhs of a general equation, or None when either side does not
    parse as an expression (single-variable 'x = 5' keeps its dedicated
    grade-the-rhs path in `_parse`)."""
    lhs, rhs = txt.split("=")
    if re.fullmatch(r"\s*[a-zA-Z]\w*\s*", lhs):
        return None
    from sympy.parsing.sympy_parser import (
        implicit_multiplication_application,
        parse_expr,
        standard_transformations,
    )

    try:
        tr = standard_transformations + (
            implicit_multiplication_application,
        )
        return parse_expr(lhs, transformations=tr, evaluate=True) - parse_expr(
            rhs, transformations=tr, evaluate=True
        )
    except Exception:
        return None


def sympy_match_worker(pred: str, gold: str) -> bool:
    """Runs inside the grading process (see answers_match_sympy)."""
    try:
        kp, vp = _parse_structure(pred)
        kg, vg = _parse_structure(gold)
        if kp != kg:
            return False
        if kp == "expr":
            return _exprs_equal(vp, vg)
        if kp == "matrix":
            if len(vp) != len(vg) or any(
                len(rp) != len(rg) for rp, rg in zip(vp, vg)
            ):
                return False
            return all(
                _exprs_equal(cp, cg)
                for rp, rg in zip(vp, vg)
                for cp, cg in zip(rp, rg)
            )
        if kp == "set":
            if len(vp) != len(vg):
                return False
            used = set()
            for p in vp:
                for i, g in enumerate(vg):
                    if i not in used and _exprs_equal(p, g):
                        used.add(i)
                        break
                else:
                    return False
            return True
        if kp == "intervals":
            if len(vp) != len(vg):
                return False
            for (lbp, lop, hip, rbp), (lbg, log_, hig, rbg) in zip(vp, vg):
                if lbp != lbg or rbp != rbg:
                    return False
                if not (_exprs_equal(lop, log_) and _exprs_equal(hip, hig)):
                    return False
            return True
        return False
    except Exception:
        return False


# ---------------- pool with hard timeout ----------------

_EXECUTOR = None


def _executor():
    global _EXECUTOR
    if _EXECUTOR is None:
        import atexit
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        # Workers come from a fork server, never a fork of this process:
        # a fork from one thread while another spawns a subprocess (the
        # code sandbox) copies that spawn's error pipe into the worker,
        # and the spawn then waits on it for as long as the worker lives.
        _EXECUTOR = ProcessPoolExecutor(
            max_workers=1, mp_context=multiprocessing.get_context("forkserver")
        )
        atexit.register(_kill_executor)
    return _EXECUTOR


def _kill_executor():
    global _EXECUTOR
    if _EXECUTOR is not None:
        ex, _EXECUTOR = _EXECUTOR, None
        procs = list((getattr(ex, "_processes", None) or {}).values())
        ex.shutdown(wait=False, cancel_futures=True)
        for p in procs:
            try:
                p.kill()
            except Exception:
                pass


def answers_match_sympy(pred: str, gold: str, timeout: float = 3.0) -> bool:
    """Symbolic equivalence with a hard per-call timeout; the worker process
    is killed and replaced on timeout (sympy.simplify can hang)."""
    from concurrent.futures import TimeoutError as FuturesTimeout

    try:
        fut = _executor().submit(sympy_match_worker, pred, gold)
        return bool(fut.result(timeout=timeout))
    except FuturesTimeout:
        _kill_executor()
        return False
    except Exception:
        _kill_executor()
        return False
