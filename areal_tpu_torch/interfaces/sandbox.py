"""Sandboxed execution of untrusted programs (port of
areal_tpu/interfaces/sandbox.py): the jail of the `python_exec` tool.

- rlimits through a `sh -c 'ulimit ...; exec "$@"'` wrapper (no
  preexec_fn, which is unsafe in a threaded host): CPU seconds, address
  space, file size, open files, process count, no core dumps;
- a minimal environment and a fresh session (process group), so a
  timeout kills the program's own children too;
- a user+network namespace (`unshare -rn`) where the kernel allows one,
  probed once (5 s bound) and cached: no network for the program.

It stops the accident class (fork and memory bombs, giant files, stray
network calls), not a determined attacker: it is not a container.
"""

import logging
import os
import shutil
import subprocess
import tempfile
from typing import List, Optional, Tuple

logger = logging.getLogger("areal_tpu_torch.sandbox")

_UNSHARE: Optional[List[str]] = None


def _unshare_prefix() -> List[str]:
    """`unshare -rn` argv prefix when user+net namespaces work here."""
    global _UNSHARE
    if _UNSHARE is None:
        exe = shutil.which("unshare")
        ok = False
        if exe:
            try:
                # No pipes (see run_sandboxed): a fork beside the probe
                # could hold one open past the probe's timeout.
                ok = subprocess.run(
                    [exe, "-rn", "true"], stdout=subprocess.DEVNULL,
                    stderr=subprocess.DEVNULL, timeout=5,
                ).returncode == 0
            except Exception:  # noqa: BLE001 — any failure means no namespace
                ok = False
        _UNSHARE = [exe, "-rn"] if ok else []
        if not _UNSHARE:
            logger.warning(
                "unshare -rn unavailable: sandboxed code keeps network access "
                "(rlimits still apply)"
            )
    return _UNSHARE


def _ulimit_wrapper(cpu_s: int, mem_mb: int, fsize_mb: int, nproc: Optional[int]) -> List[str]:
    """The rlimit wrapper: mandatory limits are &&-joined, so the program
    does not run if one fails to apply; the process cap (per user, so it
    sits above a busy host's task count) is best effort.  `ulimit -v` is
    in KiB, `-f` in 512-byte blocks, `-t` in seconds."""
    parts = [
        f"ulimit -t {cpu_s + 1}",
        f"ulimit -v {mem_mb << 10}",
        f"ulimit -f {(fsize_mb << 20) // 512}",
        "ulimit -n 256",
        "ulimit -c 0",
    ]
    script = " && ".join(parts)
    if nproc is not None:
        script += f" && {{ ulimit -u {nproc} 2>/dev/null || true; }}"
    script += ' && exec "$@"'
    return ["sh", "-c", script, "sh"]


def run_sandboxed(
    argv: List[str],
    input_text: str = "",
    timeout_s: float = 8.0,
    cwd: Optional[str] = None,
    mem_mb: int = 1024,
    fsize_mb: int = 32,
    nproc: Optional[int] = 4096,
) -> Tuple[int, str]:
    """Run `argv` jailed; returns (returncode, stdout).  A wall-clock
    timeout kills the session and returns (-1, "").

    The program reads its input from a file and writes its output to one,
    never a pipe: a process forked elsewhere in this one while the
    program runs (a process pool's fork from another thread) would hold
    the pipe's other end open, and the program would wait for an EOF, or
    this call for one, until the timeout."""
    with tempfile.TemporaryDirectory(prefix="areal_sandbox_io_") as io_dir:
        in_path, out_path = os.path.join(io_dir, "stdin"), os.path.join(io_dir, "stdout")
        with open(in_path, "w") as f:
            f.write(input_text)
        with open(in_path, "rb") as fin, open(out_path, "wb") as fout:
            proc = subprocess.Popen(
                _unshare_prefix()
                + _ulimit_wrapper(max(1, int(timeout_s)), mem_mb, fsize_mb, nproc)
                + argv,
                stdin=fin,
                stdout=fout,
                stderr=subprocess.DEVNULL,
                cwd=cwd,
                env={"PATH": "/usr/bin:/bin", "HOME": cwd or tempfile.gettempdir()},
                start_new_session=True,
            )
        try:
            proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            try:
                os.killpg(proc.pid, 9)
            except ProcessLookupError:
                pass
            proc.wait()
            return -1, ""
        with open(out_path, encoding="utf-8", errors="replace") as f:
            return proc.returncode, f.read()
