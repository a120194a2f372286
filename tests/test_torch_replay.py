"""The port's replay plane against the JAX package's: `ReplayBuffer`
(a seeded sequence of put / get_batch / set_version / can_accept /
load_watermarks calls on both packages' buffers gives equal results,
drops and watermarks; twins of tests/test_rollout.py's buffer cases),
the `SequenceBuffer`'s max-age eviction and staleness stats, and the
asynchronous fields of `RecoverInfo` (round trip, backfill of a record
from before they existed)."""

import asyncio
import pickle

import numpy as np
import pytest

from areal_tpu.api.data_api import SequenceSample as JSequenceSample
from areal_tpu.api.dfg import MFCDef as JMFCDef
from areal_tpu.base import recover as jrecover
from areal_tpu.system import buffer as jbuffer
from areal_tpu.system import replay as jreplay
from areal_tpu_torch.api.data_api import SequenceSample
from areal_tpu_torch.api.dfg import MFCDef
from areal_tpu_torch.base import recover
from areal_tpu_torch.system import buffer as tbuffer
from areal_tpu_torch.system import replay as treplay

PKGS = {"jax": jreplay, "port": treplay}


def _traj(mod, qid, v, task=""):
    return mod.Trajectory(qid=qid, prompt_ids=[1, 2], output_ids=[[3, 4]],
                          output_logprobs=[[0.0, 0.0]], no_eos=[False], version_start=v,
                          version_end=v, task=task)


def _script(seed, n_ops=120):
    """A seeded sequence of buffer calls, package-neutral."""
    rng = np.random.default_rng(seed)
    ops, version = [], 0
    for i in range(n_ops):
        r = rng.random()
        if r < 0.45:
            ops.append(("put", f"q{i}", int(version - rng.integers(0, 4)),
                        str(rng.choice(["", "math", "code"])), bool(rng.random() < 0.1)))
        elif r < 0.7:
            ops.append(("get", int(rng.integers(1, 4))))
        elif r < 0.82:
            version += int(rng.integers(0, 3))
            ops.append(("set_version", version))
        elif r < 0.95:
            ops.append(("can_accept", None if rng.random() < 0.3 else int(version - rng.integers(0, 4))))
        else:
            ops.append(("reload",))
    return ops


def _run(mod, ops, capacity, cap):
    dropped = []
    buf = mod.ReplayBuffer(capacity=capacity, max_head_offpolicyness=cap,
                           on_drop=lambda t: dropped.append(t.qid))
    out = []
    for op in ops:
        if op[0] == "put":
            _, qid, v, task, strict = op
            try:
                out.append(("put", buf.put(_traj(mod, qid, v, task), strict=strict)))
            except mod.StaleTrajectoryError:
                out.append(("put", "stale"))
        elif op[0] == "get":
            try:
                got = buf.get_batch(op[1], timeout=0)
                out.append(("get", [(t.qid, t.retired_version) for t in got]))
            except TimeoutError:
                out.append(("get", "timeout"))
        elif op[0] == "set_version":
            buf.set_version(op[1])
            out.append(("hist", sorted(buf.staleness_histogram().items())))
        elif op[0] == "can_accept":
            out.append(("can_accept", buf.can_accept(op[1])))
        else:
            # A restarted trial: a fresh buffer resumes from the watermarks.
            wm = buf.watermarks()
            buf = mod.ReplayBuffer(capacity=capacity, max_head_offpolicyness=cap,
                                   on_drop=lambda t: dropped.append(t.qid))
            buf.load_watermarks(wm)
            out.append(("reload", len(buf)))
    return out, dropped, buf.watermarks(), buf.task_watermarks(), len(buf)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("capacity,cap", [(4, 0), (6, 1), (3, 2)])
def test_seeded_calls_match_jax(seed, capacity, cap):
    ops = _script(seed)
    got = _run(treplay, ops, capacity, cap)
    want = _run(jreplay, ops, capacity, cap)
    assert got == want
    assert got[2]["accepted"] > 0 and (got[2]["rejected"] + got[2]["evicted"]
                                       + got[2]["dropped_stale"]) > 0


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_admission_fifo_and_strict(pkg):
    mod = PKGS[pkg]
    rb = mod.ReplayBuffer(capacity=8, max_head_offpolicyness=1)
    rb.set_version(2)
    assert rb.put(_traj(mod, "fresh", 2)) and rb.put(_traj(mod, "edge", 1))
    assert not rb.put(_traj(mod, "stale", 0))
    with pytest.raises(mod.StaleTrajectoryError):
        rb.put(_traj(mod, "stale2", 0), strict=True)
    assert (rb.accepted, rb.rejected) == (2, 2)
    assert [t.qid for t in rb.stream(2)] == ["fresh", "edge"]
    with pytest.raises(TimeoutError):
        rb.get_group(timeout=0.01)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_constructor_refusals(pkg):
    mod = PKGS[pkg]
    with pytest.raises(ValueError):
        mod.ReplayBuffer(capacity=0)
    with pytest.raises(ValueError):
        mod.ReplayBuffer(max_head_offpolicyness=-1)
    rb = mod.ReplayBuffer()
    rb.set_version(3)
    with pytest.raises(ValueError, match="monotonic"):
        rb.set_version(2)


def test_task_watermarks_and_old_records_match_jax():
    """Per-task consumption, and a watermark record from before task
    streams (no "tasks" key) loading with empty task stats."""
    res = {}
    for pkg, mod in PKGS.items():
        rb = mod.ReplayBuffer(capacity=8, max_head_offpolicyness=4)
        for i, (v, task) in enumerate([(0, "math"), (0, "code"), (1, "math")]):
            rb.put(_traj(mod, f"q{i}", v, task))
        rb.set_version(2)
        rb.get_batch(3, timeout=0)
        old = mod.ReplayBuffer()
        old.load_watermarks({"version": 5, "accepted": 7})
        res[pkg] = (rb.task_watermarks(), old.watermarks(), old.task_watermarks())
    assert res["port"] == res["jax"]
    assert res["port"][0]["math"] == {"consumed": 2, "staleness_mean": 1.5}


def test_blocking_get_wakes_on_put():
    """A trainer blocked in get_batch wakes when the rollout thread puts."""
    import threading

    rb = treplay.ReplayBuffer(capacity=4, max_head_offpolicyness=0)
    t = threading.Timer(0.05, lambda: rb.put(_traj(treplay, "late", 0)))
    t.start()
    try:
        assert rb.get_batch(1, timeout=10.0)[0].qid == "late"
    finally:
        t.join(timeout=10.0)


# ---------------- the SequenceBuffer's asynchronous pieces ----------------

def _meta(cls, ids):
    return cls(keys={"packed_prompts"}, ids=list(ids),
               seqlens={"packed_prompts": [[3] for _ in ids]},
               data={"packed_prompts": np.arange(3 * len(ids), dtype=np.int32)}).meta()


def _drive_sequence_buffer(mod, sample_cls, mfc_cls, max_age):
    node = mfc_cls(name="gen", model_name="m", interface_type=None, interface_impl=None,
                   input_keys=("packed_prompts",), n_seqs=2)

    async def go():
        buf = mod.SequenceBuffer(consumers={"gen": ("packed_prompts",)}, max_age_steps=max_age)
        out = []
        for step in range(5):
            await buf.put_batch(_meta(sample_cls, [f"s{step}a", f"s{step}b"]), step=step)
            out.append((buf.stats(), sorted(buf.staleness_histogram().items())))
            if step == 1:
                got = await buf.get_batch_for_rpc(node, timeout=1)
                out.append(sorted(got.ids))
        await buf.drop_ids(["s4a", "nope"])
        out.append((len(buf), buf.stats()))
        return out

    return asyncio.run(go())


@pytest.mark.parametrize("max_age", [None, 0, 2])
def test_sequence_buffer_max_age_matches_jax(max_age):
    got = _drive_sequence_buffer(tbuffer, SequenceSample, MFCDef, max_age)
    want = _drive_sequence_buffer(jbuffer, JSequenceSample, JMFCDef, max_age)
    assert got == want
    if max_age == 0:
        assert got[-1][1]["evicted_aged"] > 0


# ---------------- RecoverInfo's asynchronous fields ----------------

@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_recover_async_fields_roundtrip(tmp_path, pkg):
    mod = {"jax": jrecover, "port": recover}[pkg]
    rb = PKGS[pkg].ReplayBuffer(capacity=4, max_head_offpolicyness=1)
    rb.put(_traj(PKGS[pkg], "a", 0, "math"))
    rb.set_version(1)
    rb.get_batch(1, timeout=0)
    info = mod.RecoverInfo(
        last_step_info=mod.StepInfo(global_step=3), replay_watermarks=rb.watermarks(),
        rollout_state={"trainer_version": 3, "batch_seq": 4, "cursor": 12},
    )
    mod.dump(info, str(tmp_path))
    back = mod.load(str(tmp_path))
    assert back.replay_watermarks == rb.watermarks()
    assert back.rollout_state == {"trainer_version": 3, "batch_seq": 4, "cursor": 12}
    fresh = PKGS[pkg].ReplayBuffer(capacity=4, max_head_offpolicyness=1)
    fresh.load_watermarks(back.replay_watermarks)
    assert fresh.watermarks() == {**rb.watermarks(), "size": 0}


def test_recover_record_without_async_fields_backfills(tmp_path):
    """A record pickled before the asynchronous fields existed loads with
    empty ones, as the JAX package's does."""
    info = recover.RecoverInfo(last_step_info=recover.StepInfo(global_step=2))
    del info.replay_watermarks
    del info.rollout_state
    with open(tmp_path / recover.RECOVER_FILE, "wb") as f:
        pickle.dump(info, f)
    back = recover.load(str(tmp_path))
    assert back.replay_watermarks == {} and back.rollout_state == {}
    assert back.last_step_info.global_step == 2
