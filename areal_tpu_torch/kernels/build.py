"""Build the port's CUDA C++ sources into shared libraries at first use.

Each `areal_tpu_torch/csrc/*.cu` file has a plain C interface and is
compiled on its own by `nvcc` for Hopper (sm_90a) into
`areal_tpu_torch/_build/<name>-<hash>.so`, where the hash covers the
source, the shared headers (`csrc/*.cuh`) and the flags: an edited
source or header rebuilds, an unchanged one is reused.  Nothing is
compiled when a module is imported; the kernel wrappers call
`build_library` the first time they launch.

    python -m areal_tpu_torch.kernels.build   # build every kernel now
"""

import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Sequence, Tuple

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
# A worker process of a multi-process trial loads the libraries its
# launcher built, from the directory the launcher names.
BUILD_DIR = os.environ.get("AREAL_TORCH_BUILD_DIR") or os.path.join(PKG_DIR, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills on stderr
)


# Two MFCs may launch kernels from two threads at once (the master runs
# each in a thread of its own), and `+= 1` is a read-modify-write.
_LAUNCH_LOCK = threading.Lock()


def count_launch(counts: dict, key: str) -> None:
    """Add one to `counts[key]` under a lock: a kernel module's
    `LAUNCHES` (`count_launch(globals(), "LAUNCHES")`) or one entry of a
    dict of counts."""
    with _LAUNCH_LOCK:
        counts[key] += 1


def sources() -> List[str]:
    return sorted(
        os.path.join(CSRC_DIR, f)
        for f in os.listdir(CSRC_DIR)
        if f.endswith(".cu")
    )


def nvcc() -> str:
    """The CUDA compiler: `nvcc` on PATH, else under CUDA_HOME (or the
    toolkit's default prefix)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for prefix in (home, "/usr/local/cuda"):
        if prefix and os.path.exists(os.path.join(prefix, "bin", "nvcc")):
            return os.path.join(prefix, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME): the port's CUDA kernels are "
        "built from source on the machine with the card"
    )


def library_path(source: str) -> str:
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [source] + [os.path.join(CSRC_DIR, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")


def _start(source: str) -> Tuple[str, str, "subprocess.Popen"]:
    out = library_path(source)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-o", tmp, source],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return out, tmp, proc


def _finish(source: str, out: str, tmp: str, proc) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"nvcc failed on {os.path.relpath(source, PKG_DIR)} "
            f"(exit {proc.returncode}):\n{log}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return log


def build_all(srcs: Sequence[str] = ()) -> Dict[str, Dict]:
    """Build every stale source in parallel (one nvcc each, all started
    together).  Returns {source name: {"path", "seconds", "log"}};
    "log" is nvcc's -Xptxas -v report, empty for a reused library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.monotonic()
    jobs, result = [], {}
    for src in srcs or sources():
        name = os.path.basename(src)
        out = library_path(src)
        if os.path.exists(out):
            result[name] = {"path": out, "seconds": 0.0, "log": ""}
        else:
            jobs.append((src, *_start(src)))
    for src, out, tmp, proc in jobs:
        log = _finish(src, out, tmp, proc)
        result[os.path.basename(src)] = {
            "path": out, "seconds": time.monotonic() - t0, "log": log,
        }
    return result


def build_library(source: str) -> str:
    """Path of the built library for `source`, building it if stale."""
    return build_all([source])[os.path.basename(source)]["path"]


if __name__ == "__main__":
    for name, info in build_all().items():
        print(f"{name}: {info['path']} ({info['seconds']:.1f} s)")
        if info["log"]:
            print(info["log"])
