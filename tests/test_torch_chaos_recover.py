"""The master's recover-save kill points in both packages: the tiny trial
(tests/test_torch_recover.py's `_trial`, greedy, from one pair of
checkpoints written by the JAX package, a recover checkpoint every step)
is killed by ``AREAL_FAULTS=kill@point=<point>&skip=1&times=1`` in its
second save, in a subprocess, then run again to its end.  Held across
the packages: the exit code (42), the manifest's step and the recover
info's step after the kill, and the resumed trial's final weights.

A behaviour of the reference, pinned: a kill at ``recover_flip`` leaves
the step-2 checkpoint in place beside the step-1 recover info, and the
restart restores the step-2 weights under step 1's counters, so it
trains step 2 a second time; its final weights differ from an
uninterrupted trial's, in both packages alike (ROADMAP queue 3)."""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest

from areal_tpu.base import recover as jrecover
from areal_tpu_torch.base import recover as trecover
from tests.test_torch_recover import ckpt  # noqa: F401 — the module's checkpoint pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-4  # `_trial`'s
STEPS = 3

_RUN = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, {repo!r})
from tests.test_torch_recover import _trial, _flat_numpy
pkg, root, out = {pkg!r}, {root!r}, {out!r}
m, stats = _trial(pkg, {ckpt!r}, root, 12, {steps}, ckpt_freq=1, reward=None, ref=False,
                  offload_ref=False)
params = m.pool.workers[0].models["actor@0"].engine.get_params()
if pkg == "jax":
    import jax
    flat = {{"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}}
else:
    flat = {{k.replace(".", "/"): v for k, v in _flat_numpy(params).items()}}
np.savez(out, steps=len(stats), **flat)
"""


def _run(pkg, ckpt_pair, root, out, faults=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env.pop("AREAL_FAULTS", None)
    if faults:
        env["AREAL_FAULTS"] = faults
    code = _RUN.format(repo=REPO, pkg=pkg, root=str(root), out=str(out), ckpt=tuple(ckpt_pair),
                       steps=STEPS)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)


def _steps(pkg, root):
    """(the manifest's step, the recover info's step) under `root`."""
    mod = jrecover if pkg == "jax" else trecover
    bases = glob.glob(os.path.join(root, "checkpoints", "*", "*", "*", "recover_checkpoint"))
    assert len(bases) == 1, bases
    manifest = mod.validate_manifest(bases[0])
    infos = glob.glob(os.path.join(root, "recover", "*", "*"))
    assert len(infos) == 1, infos
    info = mod.load(infos[0])
    return manifest["step"], info.last_step_info.global_step


@pytest.fixture(scope="module")
def uninterrupted(ckpt, tmp_path_factory):  # noqa: F811
    """The port's trial run to its end without a fault, in this process
    on one thread (as the subprocesses run)."""
    import torch

    from tests.test_torch_recover import _flat_numpy, _trial

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        m, _ = _trial("port", ckpt, tmp_path_factory.mktemp("u"), 12, STEPS, ckpt_freq=1,
                      reward=None, ref=False, offload_ref=False)
    finally:
        torch.set_num_threads(threads)
    params = m.pool.workers[0].models["actor@0"].engine.get_params()
    return {k.replace(".", "/"): v for k, v in _flat_numpy(params).items()}


@pytest.mark.parametrize("point", ["recover_stage", "recover_flip"])
def test_recover_kill_point_matches_jax(tmp_path, ckpt, uninterrupted, point):  # noqa: F811
    got = {}
    for pkg in ("jax", "port"):
        root = tmp_path / pkg
        killed = _run(pkg, ckpt, root, tmp_path / f"{pkg}_killed.npz",
                      faults=f"kill@point={point}&skip=1&times=1")
        assert not (tmp_path / f"{pkg}_killed.npz").exists()
        after_kill = _steps(pkg, root)
        resumed = _run(pkg, ckpt, root, tmp_path / f"{pkg}.npz")
        assert resumed.returncode == 0, (pkg, resumed.stderr[-3000:])
        got[pkg] = (killed.returncode, after_kill, _steps(pkg, root),
                    dict(np.load(tmp_path / f"{pkg}.npz")))
    (trc, tkill, tend, tw), (jrc, jkill, jend, jw) = got["port"], got["jax"]
    assert trc == jrc == 42
    # recover_stage: nothing flipped, both at step 1; recover_flip: the
    # step-2 checkpoint flipped, the recover info still step 1's.
    assert tkill == jkill == ((1, 1) if point == "recover_stage" else (2, 1))
    assert tend == jend == (STEPS, STEPS)
    assert set(tw) == set(jw)
    for k in jw:
        if k == "steps":
            continue
        np.testing.assert_allclose(tw[k], jw[k], atol=STEPS * LR / 100, rtol=0, err_msg=k)
    # The restart runs steps 2 and 3.  After recover_stage it equals the
    # uninterrupted trial bit for bit; after recover_flip it trained step
    # 2 a second time, from the step-2 weights (the pinned behaviour).
    assert int(tw["steps"]) == int(jw["steps"]) == STEPS - 1
    diff = max(float(np.abs(tw[k] - uninterrupted[k]).max()) for k in uninterrupted)
    assert (diff == 0.0) == (point == "recover_stage"), diff
