"""Runs the legs of `python -m areal_tpu_torch.scripts.check_async` at
``--model tiny --device cpu`` in a subprocess (`run_leg`,
`assert_leg_passes`, used by the other chaos-leg tests), and holds the
command line's refusals: no card without ``--device cpu``, and
``--bench-out``."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_leg(*flags, timeout=600):
    """The leg's CompletedProcess (no card visible, the file name_resolve
    and fault environment of the caller left out)."""
    e = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    for k in ("AREAL_FAULTS", "AREAL_TRACE", "AREAL_TRACE_DIR", "AREAL_NAME_RESOLVE",
              "AREAL_NAME_RESOLVE_ROOT"):
        e.pop(k, None)
    return subprocess.run(
        [sys.executable, "-m", "areal_tpu_torch.scripts.check_async", *flags], cwd=REPO,
        env=e, capture_output=True, text=True, timeout=timeout)


def assert_leg_passes(*flags, timeout=600):
    r = run_leg("--model", "tiny", "--device", "cpu", *flags, timeout=timeout)
    tail = (r.stdout[-4000:], r.stderr[-4000:])
    assert r.returncode == 0, tail
    assert r.stdout.strip().splitlines()[-1].startswith("OK: "), tail
    assert "FAIL" not in r.stdout, tail
    return r.stdout


def test_no_card_exits_nonzero_and_names_the_device():
    r = run_leg("--nan-chaos", timeout=120)
    assert r.returncode != 0 and "OK" not in r.stdout
    assert "no CUDA device" in r.stderr and "--device cpu" in r.stderr


def test_bench_out_is_refused(tmp_path):
    r = run_leg("--device", "cpu", "--nan-chaos", "--bench-out", str(tmp_path / "b.json"),
                timeout=120)
    assert r.returncode != 0 and "--bench-out is not ported" in r.stderr
    assert not (tmp_path / "b.json").exists()
