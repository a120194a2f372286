"""The port's recovery against the JAX package's: `base/recover.py` (the
atomic, manifest-validated checkpoint dirs, twins of
tests/test_crash_safety.py:83-169, a manifest written by either package
validated by the other), `base/timeutil.FrequencyControl`, the master's
recover save and restore over a stub pool (twins of
tests/test_crash_safety.py:443-517), and whole trials through both
packages' `run_experiment` at `tiny_config`:

- the fetch top-up of a dataset whose size is not a multiple of the
  batch size (fetch sizes 4, 4, 5; stats within rtol 1e-4, atol 1e-6,
  tests/test_torch_experiments.py's parity tolerance);
- the EMA reference model (twins of tests/test_experiments.py:350 and
  :396; the mix bit for bit against JAX's on bf16 leaves);
- the difficulty filter (twin of tests/test_experiments.py:183: the same
  removed ids);
- kill-and-resume: GRPO with a ref, the EMA and the filter, a restart
  after step 1, then step 3: the port's tokens equal its uninterrupted
  run's and its stats agree within 1e-6 (one torch thread, where the CPU
  kernels are deterministic), and the resumed run agrees with the JAX
  package's resumed run (tokens equal, stats within 1e-4);
- two behaviours of the reference, pinned in both packages: a restart
  after a mid-epoch filter drop replays the data cursor over the
  shrunken dataset's permutation, and a restart at step k > 1 rebuilds
  the EMA reference from its initial weights;
- the quarantine rollback with NaN rewards, and the recovery budget.
"""

import asyncio
import contextlib
import dataclasses
import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from areal_tpu.api import model_api as jmodel_api
from areal_tpu.api.config import ModelAbstraction as JModelAbstraction
from areal_tpu.api.config import ModelInterfaceAbstraction as JInterfaceAbstraction
from areal_tpu.api.data_api import DatasetAbstraction as JDatasetAbstraction
from areal_tpu.api.data_api import SequenceSample as JSequenceSample
from areal_tpu.api.model_api import GenerationHyperparameters as JGenerationHyperparameters
from areal_tpu.api.model_api import OptimizerConfig as JOptimizerConfig
from areal_tpu.base import recover as jrecover
from areal_tpu.base import timeutil as jtimeutil
from areal_tpu.experiments import common as jexps
from areal_tpu.models import transformer as jtfm
from areal_tpu.models.config import tiny_config as jtiny
from areal_tpu.models.hf import registry as jhf
from areal_tpu.system import master as jmaster
from areal_tpu.system import worker as jworker
from areal_tpu_torch.api import model_api
from areal_tpu_torch.api.config import ModelAbstraction, ModelInterfaceAbstraction
from areal_tpu_torch.api.data_api import DatasetAbstraction, SequenceSample
from areal_tpu_torch.api.model_api import GenerationHyperparameters, OptimizerConfig
from areal_tpu_torch.base import recover, timeutil
from areal_tpu_torch.data.datasets import MathCodePromptDataset, PackedDataLoader
from areal_tpu_torch.data.tokenizer import CharTokenizer
from areal_tpu_torch.engines import train as ttrain
from areal_tpu_torch.experiments import common as exps
from areal_tpu_torch.system import master as tmaster
from areal_tpu_torch.system import worker as tworker
from tests import fixtures

torch.set_num_threads(2)

PKGS = {"port": recover, "jax": jrecover}


# ---------------- base/recover.py ----------------


def _make_ckpt(d, files=(("model.safetensors", b"w" * 64),)):
    os.makedirs(d, exist_ok=True)
    for name, data in files:
        with open(os.path.join(d, name), "wb") as f:
            f.write(data)


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("port", "jax"), ("jax", "port")])
def test_manifest_round_trip(tmp_path, writer, reader):
    """A manifest written by one package validates in the other, and
    both packages write the same manifest for the same dir."""
    d = str(tmp_path / "ck")
    _make_ckpt(d, (("model.safetensors", b"x" * 10), ("config.json", b"{}")))
    m = PKGS[writer].write_manifest(d, step=3, model_versions={"actor": 7})
    assert PKGS[reader].validate_manifest(d) == m
    assert m["step"] == 3 and m["model_versions"] == {"actor": 7}
    assert sorted(e["name"] for e in m["files"]) == ["config.json", "model.safetensors"]
    other = "jax" if writer == "port" else "port"
    assert PKGS[other].write_manifest(d, step=3, model_versions={"actor": 7}) == m


def _tampering(mod, d):
    """validate_manifest after a torn file, a missing file and a
    corrupted manifest body."""
    out = []
    _make_ckpt(d)
    mod.write_manifest(d, step=1)
    with open(os.path.join(d, "model.safetensors"), "wb") as f:
        f.write(b"torn")
    out.append(mod.validate_manifest(d))
    _make_ckpt(d)
    mod.write_manifest(d, step=1)
    os.unlink(os.path.join(d, "model.safetensors"))
    out.append(mod.validate_manifest(d))
    _make_ckpt(d)
    mod.write_manifest(d, step=1)
    p = os.path.join(d, mod.MANIFEST_FILE)
    with open(p) as f:
        m = json.load(f)
    m["step"] = 999  # the body no longer matches the checksum
    with open(p, "w") as f:
        json.dump(m, f)
    out.append(mod.validate_manifest(d))
    _make_ckpt(d)
    out.append(mod.write_manifest(d, step=2) == mod.validate_manifest(d))
    return out


def test_validate_rejects_tampering(tmp_path):
    got = _tampering(recover, str(tmp_path / "port"))
    assert got == _tampering(jrecover, str(tmp_path / "jax")) == [None, None, None, True]


def test_manifest_less_dir_is_invalid(tmp_path):
    d = str(tmp_path / "no_manifest")
    _make_ckpt(d)
    assert recover.validate_manifest(d) is None and jrecover.validate_manifest(d) is None
    assert recover.latest_valid_checkpoint(d) is None


def _rotations(mod, base):
    for step, blob in ((1, b"a" * 8), (2, b"b" * 16), (3, b"c" * 24)):
        staged = mod.stage_dir(base, step)
        _make_ckpt(staged, (("model.safetensors", blob),))
        mod.write_manifest(staged, step)
        assert mod.commit_checkpoint(staged, base) == base
        assert not os.path.exists(staged)
    prev = base + mod.PREV_SUFFIX
    return (mod.validate_manifest(base), mod.validate_manifest(prev),
            mod.latest_valid_checkpoint(base) == base,
            sorted(os.listdir(os.path.dirname(base))))


def test_commit_rotates_keep_last_2(tmp_path):
    """Three commits keep the current and the previous checkpoint only;
    the port's dirs and manifests equal the JAX package's."""
    os.makedirs(tmp_path / "port")
    os.makedirs(tmp_path / "jax")
    got = _rotations(recover, str(tmp_path / "port" / "recover_checkpoint"))
    want = _rotations(jrecover, str(tmp_path / "jax" / "recover_checkpoint"))
    assert got == want
    assert got[0]["step"] == 3 and got[1]["step"] == 2 and got[2]
    assert got[3] == ["recover_checkpoint", "recover_checkpoint.prev"]


def test_commit_refuses_invalid_stage(tmp_path):
    base = str(tmp_path / "recover_checkpoint")
    staged = recover.stage_dir(base, 1)
    assert staged == jrecover.stage_dir(base, 1)
    _make_ckpt(staged)  # no manifest written
    with pytest.raises(RuntimeError, match="manifest"):
        recover.commit_checkpoint(staged, base)


def test_torn_current_falls_back_to_prev(tmp_path):
    """A torn current checkpoint falls back to .prev, in either package,
    whichever package committed them."""
    base = str(tmp_path / "recover_checkpoint")
    for step, mod in ((1, jrecover), (2, recover)):
        staged = mod.stage_dir(base, step)
        _make_ckpt(staged, (("model.safetensors", bytes(8 * step)),))
        mod.write_manifest(staged, step)
        mod.commit_checkpoint(staged, base)
    assert recover.latest_valid_checkpoint(base) == jrecover.latest_valid_checkpoint(base) == base
    with open(os.path.join(base, "model.safetensors"), "wb") as f:
        f.write(b"x")
    prev = base + recover.PREV_SUFFIX
    assert recover.latest_valid_checkpoint(base) == jrecover.latest_valid_checkpoint(base) == prev


def test_clean_stale_stages(tmp_path):
    base = str(tmp_path / "recover_checkpoint")
    _make_ckpt(recover.stage_dir(base, 1))
    _make_ckpt(recover.stage_dir(base, 2))
    _make_ckpt(base)
    removed = recover.clean_stale_stages(base)
    assert sorted(removed) == sorted([recover.stage_dir(base, 1), recover.stage_dir(base, 2)])
    assert os.path.isdir(base) and not os.path.exists(recover.stage_dir(base, 1))
    assert jrecover.clean_stale_stages(base) == []


def test_old_pickle_backfills_new_fields(tmp_path):
    """A RecoverInfo pickled before a field existed still loads, with the
    field's default, as in the JAX package."""
    info = recover.RecoverInfo(last_step_info=recover.StepInfo(global_step=5))
    for fld in ("model_versions", "interface_states", "quarantine_ledger"):
        del info.__dict__[fld]
    root = str(tmp_path)
    with open(os.path.join(root, recover.RECOVER_FILE), "wb") as f:
        pickle.dump(info, f)
    loaded = recover.load(root)
    assert loaded.last_step_info.global_step == 5
    assert loaded.model_versions == {} and loaded.interface_states == {}
    assert loaded.quarantine_ledger == [] and loaded.consecutive_quarantines == 0
    common = {f.name for f in dataclasses.fields(jrecover.RecoverInfo)}
    assert {f.name for f in dataclasses.fields(recover.RecoverInfo)} <= common


# ---------------- base/timeutil.py ----------------


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


FREQ_CASES = {
    "steps": (dict(frequency_steps=3), [(1, 0)] * 7),
    "epochs": (dict(frequency_epochs=2), [(1, 0), (1, 1), (1, 0), (1, 1), (1, 1)]),
    "seconds": (dict(frequency_seconds=10.0), [(1, 0)] * 6),
    "initial": (dict(frequency_steps=2, initial_value=True), [(1, 0)] * 5),
    "steps_or_seconds": (dict(frequency_steps=4, frequency_seconds=10.0), [(1, 0)] * 8),
    "inert": (dict(), [(1, 1)] * 3),
}


def _freq_trace(mod, kw, calls, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(mod.time, "monotonic", clock)
    ctl = mod.FrequencyControl(**kw)
    out = []
    for i, (steps, epochs) in enumerate(calls):
        clock.t += 4.0
        out.append(ctl.check(steps=steps, epochs=epochs))
        if i == len(calls) // 2:
            # A recover checkpoint's round trip mid-sequence.
            sd = ctl.state_dict()
            out.append(sd)
            ctl = mod.FrequencyControl(**kw)
            ctl.load_state_dict(sd)
    return out


@pytest.mark.parametrize("case", sorted(FREQ_CASES))
def test_frequency_control_matches_jax(case, monkeypatch):
    kw, calls = FREQ_CASES[case]
    got = _freq_trace(timeutil, kw, calls, monkeypatch)
    assert got == _freq_trace(jtimeutil, kw, calls, monkeypatch)
    assert any(x is True for x in got) == (case != "inert")


# ---------------- the master's recover save and restore (stub pool) ----------------


def _stub_pool(base_cls):
    class StubPool(base_cls):
        """Serves the master's save/restore requests from memory, writing
        small real files for weight and optimizer saves."""

        def __init__(self):
            self.calls = []
            self.versions = {"default@0": 7}

        @property
        def n_workers(self):
            return 1

        async def request(self, worker_id, payload, timeout=None):
            t = payload["type"]
            self.calls.append(payload)
            if t == "save":
                os.makedirs(payload["save_dir"], exist_ok=True)
                with open(os.path.join(payload["save_dir"], "model.safetensors"), "wb") as f:
                    f.write(b"w" * 32)
                return {"path": payload["save_dir"]}
            if t == "save_optimizer":
                os.makedirs(os.path.dirname(payload["path"]), exist_ok=True)
                with open(payload["path"], "wb") as f:
                    f.write(b"o" * 16)
                return {}
            if t == "model_versions":
                return {"versions": dict(self.versions)}
            if t == "data_state":
                return {"states": [{"epoch": 1, "cursor": 3}]}
            if t == "interface_state":
                return {"states": {"default@0": {"mean": 0.5}}}
            return {}

    return StubPool


def _make_master(pkg, fileroot):
    if pkg == "jax":
        from areal_tpu.api.config import ModelInterfaceAbstraction as IA
        from areal_tpu.api.config import ModelInterfaceType as IT
        from areal_tpu.api.config import ModelName as MN
        from areal_tpu.api.data_api import MicroBatchSpec as MBS
        from areal_tpu.api.dfg import MFCDef as Def
        from areal_tpu.api.dfg import build_graph as bg
        mod = jmaster
    else:
        from areal_tpu_torch.api.config import ModelInterfaceAbstraction as IA
        from areal_tpu_torch.api.config import ModelInterfaceType as IT
        from areal_tpu_torch.api.config import ModelName as MN
        from areal_tpu_torch.api.data_api import MicroBatchSpec as MBS
        from areal_tpu_torch.api.dfg import MFCDef as Def
        from areal_tpu_torch.api.dfg import build_graph as bg
        mod = tmaster
    node = Def(name="train", model_name=MN("default", 0), interface_type=IT.TRAIN_STEP,
               interface_impl=IA("sft"), input_keys=("packed_input_ids",), n_seqs=2,
               mb_spec=MBS())
    pool = _stub_pool(mod.WorkerPool)()
    master = mod.MasterWorker(
        dfg=bg([node]), pool=pool, model_placement={"default@0": 0}, data_worker_ids=[0],
        ctrl=mod.ExperimentSaveEvalControl(ckpt_freq_steps=1), fileroot=fileroot,
        experiment_name="crash", trial_name="t0",
    )
    return master, pool


def _rec(pkg):
    return PKGS[pkg]


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_recover_save_commits_manifest_and_info(tmp_path, pkg):
    fileroot = str(tmp_path)
    master, pool = _make_master(pkg, fileroot)
    master.step_info = _rec(pkg).StepInfo(epoch=0, epoch_step=2, global_step=2)
    asyncio.run(master.save(kind="recover"))
    base = master._ckpt_dir(master._train_rpcs[0], "recover_checkpoint")
    m = recover.validate_manifest(base)  # the port validates either's
    assert m is not None and m["step"] == 2 and m["model_versions"] == {"default@0": 7}
    opt = {"port": tmaster.OPTIMIZER_FILE, "jax": "optimizer_state.pkl"}[pkg]
    assert sorted(e["name"] for e in m["files"]) == ["model.safetensors", opt]
    assert sorted(os.listdir(os.path.dirname(base))) == ["recover_checkpoint"]
    info = _rec(pkg).load(_rec(pkg).recover_root(fileroot, "crash", "t0"))
    assert info.model_versions == {"default@0": 7}
    assert dataclasses.asdict(info.last_step_info) == dict(epoch=0, epoch_step=2, global_step=2)
    assert [c["type"] for c in pool.calls] == [
        "model_versions", "save", "save_optimizer", "data_state", "interface_state"]


def _round_trip(pkg, fileroot):
    master, _ = _make_master(pkg, fileroot)
    master.step_info = _rec(pkg).StepInfo(epoch=1, epoch_step=0, global_step=4)
    asyncio.run(master.save(kind="recover"))
    saved = _rec(pkg).load(_rec(pkg).recover_root(fileroot, "crash", "t0"))
    master2, pool2 = _make_master(pkg, fileroot)
    assert master2.load_recover_info()
    assert master2.step_info == master.step_info
    restored = dataclasses.asdict(master2._restore_pending)
    assert restored == dataclasses.asdict(saved)
    asyncio.run(master2._restore_worker_state())
    base = master2._ckpt_dir(master2._train_rpcs[0], "recover_checkpoint")
    calls = [(c["type"], c.get("ckpt_dir") == base, c.get("versions"), c.get("states"))
             for c in pool2.calls]
    return restored, calls


def test_round_trip_bit_identical(tmp_path):
    """Save, then a new master (a restarted process) loads the recover
    info and restores the worker: the same counters, the same requests
    with the same payloads as the JAX master's."""
    got, got_calls = _round_trip("port", str(tmp_path / "port"))
    want, want_calls = _round_trip("jax", str(tmp_path / "jax"))
    assert got_calls == want_calls
    assert got_calls[0] == ("load_model", True, None, None)
    assert ("set_model_versions", False, {"default@0": 7}, None) in got_calls
    assert ("load_data_state", False, None, [{"epoch": 1, "cursor": 3}]) in got_calls
    # The port's controls are the JAX master's but its eval control (a
    # later item); the elapsed seconds are the wall clock's.
    assert sorted(got["save_ctl_states"]) == ["ckpt", "save"]
    for name, sd in got["save_ctl_states"].items():
        want_sd = want["save_ctl_states"][name]
        assert {k: v for k, v in sd.items() if k != "elapsed"} == {
            k: v for k, v in want_sd.items() if k != "elapsed"}
    for k in got:
        if k != "save_ctl_states":
            assert got[k] == want[k], k


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_restore_falls_back_to_prev_on_torn_current(tmp_path, pkg):
    fileroot = str(tmp_path)
    master, _ = _make_master(pkg, fileroot)
    for step in (1, 2):
        master.step_info = _rec(pkg).StepInfo(global_step=step)
        asyncio.run(master.save(kind="recover"))
    base = master._ckpt_dir(master._train_rpcs[0], "recover_checkpoint")
    with open(os.path.join(base, "model.safetensors"), "wb") as f:
        f.write(b"t")
    master2, pool2 = _make_master(pkg, fileroot)
    assert master2.load_recover_info()
    asyncio.run(master2._restore_worker_state())
    loads = [c for c in pool2.calls if c["type"] == "load_model"]
    assert loads[0]["ckpt_dir"] == base + recover.PREV_SUFFIX


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_restore_refuses_when_both_torn(tmp_path, pkg):
    fileroot = str(tmp_path)
    master, _ = _make_master(pkg, fileroot)
    master.step_info = _rec(pkg).StepInfo(global_step=1)
    asyncio.run(master.save(kind="recover"))
    base = master._ckpt_dir(master._train_rpcs[0], "recover_checkpoint")
    os.unlink(os.path.join(base, recover.MANIFEST_FILE))
    master2, _ = _make_master(pkg, fileroot)
    assert master2.load_recover_info()
    with pytest.raises(RuntimeError, match="torn checkpoint"):
        asyncio.run(master2._restore_worker_state())


# ---------------- whole trials through both packages ----------------

# The reward double: each prompt's group scored by its query id, the same
# in both packages.  Ids i % 3 == 0 get every response +5 (accuracy 1),
# i % 3 == 1 every response -5 (accuracy 0), i % 3 == 2 alternate +5/-5
# (accuracy 0.5); ids in `mixed` alternate too.  The calls listed in
# `nan_calls` (1-based, per package) return NaN rewards.
_REWARD = {"mixed": set(), "nan_calls": set(), "calls": {"jax": 0, "port": 0}}
_SEEN = {"jax": [], "port": []}


def _reward_class(sample_cls, base, pkg):
    @dataclasses.dataclass
    class RecoverTestReward(base):
        def inference(self, model, sample, mb_spec):
            _REWARD["calls"][pkg] += 1
            nan = _REWARD["calls"][pkg] in _REWARD["nan_calls"]
            _SEEN[pkg].append((list(sample.ids),
                               np.asarray(sample.data["packed_input_ids"]).copy()))
            seqlens, rewards = [], []
            for sid, group in zip(sample.ids, sample.seqlens["packed_input_ids"]):
                i = int(str(sid).split("-")[1])
                mixed = sid in _REWARD["mixed"] or i % 3 == 2
                seqlens.append([1] * len(group))
                for j in range(len(group)):
                    good = (j % 2 == 0) if mixed else (i % 3 == 0)
                    rewards.append(float("nan") if nan else (5.0 if good else -5.0))
            return sample_cls(
                keys={"rewards"}, ids=list(sample.ids), seqlens={"rewards": seqlens},
                data={"rewards": np.asarray(rewards, np.float32)},
            )

    return RecoverTestReward


_RECOVER_REWARD = "recover-test-reward-by-query-id"
if _RECOVER_REWARD not in model_api.ALL_INTERFACES:
    model_api.register_interface(
        _RECOVER_REWARD, _reward_class(SequenceSample, model_api.ModelInterface, "port"))
if _RECOVER_REWARD not in jmodel_api.ALL_INTERFACES:
    jmodel_api.register_interface(
        _RECOVER_REWARD, _reward_class(JSequenceSample, jmodel_api.ModelInterface, "jax"))


@contextlib.contextmanager
def _reward(mixed=(), nan_calls=()):
    _REWARD.update(mixed=set(mixed), nan_calls=set(nan_calls), calls={"jax": 0, "port": 0})
    _SEEN["jax"].clear()
    _SEEN["port"].clear()
    try:
        yield _SEEN
    finally:
        _REWARD.update(mixed=set(), nan_calls=set())


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """Two tiny qwen2 checkpoints written by the JAX package, the actor's
    and the reference model's: both packages' trials start from the same
    weights.  The ref differs from the actor, so the KL penalty gives
    every step a gradient: with greedy decoding a group's responses are
    identical and their group-normalized task advantages cancel."""
    paths = []
    for key in (11, 12):
        path = str(tmp_path_factory.mktemp(f"ckpt{key}"))
        jhf.save_hf_checkpoint(path, jtiny(), jtfm.init_params(jtiny(), jax.random.PRNGKey(key)),
                               model_type="qwen2")
        paths.append(path)
    return tuple(paths)


def _trial(pkg, ckpt, root, n_rows, steps, *, trial="trial", ckpt_freq=None, ema=0.5,
           dataset_filter=None, greedy=True, epochs=2, mcq=3, max_recoveries=3,
           reward=_RECOVER_REWARD, offload_ref=True, ref=True, dataset_args=None, lr=1e-4,
           ckpt_freq_secs=None, gen_args=None):
    """One trial of either package from the checkpoints `ckpt` (actor,
    ref): GRPO with a ref (EMA `ema`, kl_ctl 0.1), 4 prompts x 2
    responses, 8 new tokens, 2 minibatches, lr 1e-4 (the parity case's
    of tests/test_torch_experiments.py)."""
    rows = fixtures.build_math_rows(n_rows, seed=4)
    j = pkg == "jax"
    M = JModelAbstraction if j else ModelAbstraction
    kw = dict(
        actor=M("hf", {"path": ckpt[0]}),
        ref=M("hf", {"path": ckpt[1]}) if ref else None,
        dataset=(JDatasetAbstraction if j else DatasetAbstraction)(
            "math_code_prompt",
            {"dataset_builder": lambda: rows, "max_length": 64, **(dataset_args or {})}),
        gconfig=(JGenerationHyperparameters if j else GenerationHyperparameters)(
            n=2, max_new_tokens=8, greedy=greedy),
        ppo_kwargs={"n_minibatches": 2, "kl_ctl": 0.1 if ref else 0.0},
        optimizer=(JOptimizerConfig if j else OptimizerConfig)(
            lr=lr, warmup_steps_proportion=0.0),
        ref_ema_eta=ema if ref else None, offload_ref=offload_ref and ref,
        dataset_filter=dataset_filter,
        batch_size=4, total_train_epochs=epochs,
        ctrl=(jmaster if j else tmaster).ExperimentSaveEvalControl(
            benchmark_steps=steps, ckpt_freq_steps=ckpt_freq, ckpt_freq_secs=ckpt_freq_secs),
        gen_backend_args=dict(gen_args or {}),
        fileroot=str(root), trial_name=trial,
        max_consecutive_quarantines=mcq, max_recoveries=max_recoveries,
    )
    if reward is None:
        kw["reward_interface_args"] = {"id2info": {r["query_id"]: r for r in rows}}
    else:
        kw["reward_interface"] = (JInterfaceAbstraction if j else ModelInterfaceAbstraction)(reward)
    if j:
        return jexps.run_experiment(jexps.build_ppo_math(jexps.PPOMathConfig(**kw)),
                                    tokenizer=fixtures.make_tokenizer())
    return exps.run_experiment(exps.build_ppo_math(exps.PPOMathConfig(**kw)),
                               tokenizer=CharTokenizer(512), device="cpu")


def _train_keys(stats):
    return [k for k in stats if k.split("/")[0] == "actor_train"
            and "/perf/" not in k and "/time/" not in k]


def _assert_stats_close(got, want, rtol, atol=0.0):
    assert len(got) == len(want)
    for step, (g, w) in enumerate(zip(got, want)):
        keys = _train_keys(w)
        assert keys and sorted(_train_keys(g)) == sorted(keys)
        for k in keys:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol, equal_nan=True,
                                       err_msg=f"step {step + 1}: {k}")


def _flat_numpy(tree):
    """Copies of a params tree's leaves as fp32 numpy arrays."""
    return {n: np.array(t.detach().float().cpu().numpy() if torch.is_tensor(t) else t,
                        np.float32, copy=True)
            for n, t in ttrain._leaves(tree)}


def _first_batch_ids(n_rows):
    """The ids of the first batch the worker's loader yields (seed 1)."""
    rows = fixtures.build_math_rows(n_rows, seed=4)
    ds = MathCodePromptDataset(1, 0, 1, CharTokenizer(512), dataset_builder=lambda: rows,
                               max_length=64)
    return set(next(iter(PackedDataLoader(ds, 4, seed=1))).ids)


def test_fetch_tops_up_a_short_batch(tmp_path, ckpt, monkeypatch):
    """A dataset of 10 rows in batches of 4: the third fetch tops the
    epoch's last 2 rows up from the next epoch, dropping a repeated id
    (sizes 4, 4, 5 in both packages), and one entry stays in the buffer
    at step 3.  No filter, a frozen ref; stats within rtol 1e-4, atol
    1e-6."""
    sizes = {"jax": [], "port": []}
    for pkg, mod in (("jax", jworker), ("port", tworker)):
        orig = mod.ModelWorker._handle_fetch

        def fetch(self, req, orig=orig, pkg=pkg):
            out = orig(self, req)
            sizes[pkg].append(len(out["meta"].ids))
            return out

        monkeypatch.setattr(mod.ModelWorker, "_handle_fetch", fetch)
    with _reward() as seen:
        _, jstats = _trial("jax", ckpt, tmp_path / "jax", 10, None, epochs=1, ema=None)
        _, tstats = _trial("port", ckpt, tmp_path / "port", 10, None, epochs=1, ema=None)
        assert sizes["port"] == sizes["jax"] == [4, 4, 5]
        assert [s["buffer/size"] for s in tstats] == [s["buffer/size"] for s in jstats] == [
            0.0, 0.0, 1.0]
        for (tids, ttoks), (jids, jtoks) in zip(seen["port"], seen["jax"]):
            assert tids == jids
            np.testing.assert_array_equal(ttoks, jtoks)
    _assert_stats_close(tstats, jstats, rtol=1e-4, atol=1e-6)


def test_int8_kv_runs_like_jax(tmp_path, ckpt):
    """`kv_cache_dtype="int8"`, once refused by the port, runs in both
    packages; the static path ignores it in both, so greedy tokens are
    equal and stats within rtol 1e-4, atol 1e-6."""
    with _reward() as seen:
        (jm, jstats), (tm, tstats) = (
            _trial(pkg, ckpt, tmp_path / pkg, 8, 2, ema=None, gen_args={"kv_cache_dtype": "int8"})
            for pkg in ("jax", "port"))
        for (tids, ttoks), (jids, jtoks) in zip(seen["port"], seen["jax"]):
            assert tids == jids
            np.testing.assert_array_equal(ttoks, jtoks)
    assert tm.pool.workers[0].models["actor_gen@0"].engine.kv_cache_dtype == "int8"
    _assert_stats_close(tstats, jstats, rtol=1e-4, atol=1e-6)


def test_ckpt_freq_secs_saves_like_jax(tmp_path, ckpt):
    """`ckpt_freq_secs=0`: a recover checkpoint after every step in both
    packages (the current one at step 2, `.prev` at step 1), and the
    recover info's step account equal."""
    got = {}
    with _reward():
        for pkg in ("jax", "port"):
            m, _ = _trial(pkg, ckpt, tmp_path / pkg, 8, 2, ema=None, ckpt_freq_secs=0.0)
            base = m._ckpt_dir(m._train_rpcs[0], "recover_checkpoint")
            info = PKGS[pkg].load(PKGS[pkg].recover_root(str(tmp_path / pkg), "ppo-math", "trial"))
            got[pkg] = (recover.validate_manifest(base)["step"],
                        recover.validate_manifest(base + recover.PREV_SUFFIX)["step"],
                        dataclasses.asdict(info.last_step_info))
    assert got["port"] == got["jax"] == (2, 1, dict(epoch=1, epoch_step=0, global_step=2))


@pytest.mark.parametrize("drop_last", [False, True])
def test_loader_after_a_filter_matches_jax(drop_last):
    """PackedDataLoader over 11 math rows in batches of 4 (seed 3): the
    difficulty filter removes three ids after the first batch, and the
    rest of the epoch walks the snapshot permutation over the shrunken
    list, dropping stale indices (a short batch, or with drop_last the
    epoch's end), then the next epoch; both packages yield the same ids."""
    from areal_tpu.data.datasets import MathCodePromptDataset as JMath
    from areal_tpu.data.datasets import PackedDataLoader as JLoader

    rows = fixtures.build_math_rows(11, seed=4)
    out = {}
    for pkg, ds_cls, dl_cls, tok in (("port", MathCodePromptDataset, PackedDataLoader,
                                      CharTokenizer(512)),
                                     ("jax", JMath, JLoader, fixtures.make_tokenizer())):
        ds = ds_cls(1, 0, 1, tok, dataset_builder=lambda: rows, max_length=64,
                    max_filter_percentage=0.5)
        dl = dl_cls(ds, 4, seed=3, drop_last=drop_last)
        it = iter(dl)
        batches = [list(next(it).ids)]
        removed = ds.filter(["math-1", "math-4", "math-7", "math-99"])
        batches += [list(b.ids) for b in it] + [list(b.ids) for b in dl]
        out[pkg] = (removed, batches, list(ds.ids))
    assert out["port"] == out["jax"]
    removed, batches, ids = out["port"]
    assert removed == 3 and len(ids) == 8
    assert all(len(b) == 4 for b in batches) == drop_last


def test_fetch_raises_after_16_attempts(tmp_path):
    """A dataset filtered to fewer distinct ids than a batch cannot fill
    one: the fetch raises instead of looping."""
    rows = fixtures.build_math_rows(8, seed=4)
    cfg = tworker.WorkerConfig(
        worker_index=0, shards=[], batch_size=4,
        datasets=[DatasetAbstraction("math_code_prompt",
                                     {"dataset_builder": lambda: rows, "max_length": 64})],
    )
    worker = tworker.ModelWorker(cfg, tokenizer=CharTokenizer(512), device="cpu")
    assert worker.handle_request({"type": "filter_dataset", "ids": [r["query_id"] for r in rows[:6]]}) == {
        "removed": 6}
    with pytest.raises(RuntimeError, match="cannot fill a batch of 4"):
        worker.handle_request({"type": "fetch"})


# ---------------- the EMA reference model ----------------


class _Params:
    """An engine stand-in holding a params tree."""

    def __init__(self, params):
        self.params = params

    def get_params(self):
        return self.params

    def set_params(self, params):
        self.params = {k: v.clone() for k, v in params.items()}


@pytest.mark.parametrize("ref_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("eta", [0.9, 0.5, 0.001])
def test_ema_mix_matches_jax_bit_for_bit(ref_dtype, eta):
    """The worker's EMA (`param_sync` with eta < 1) on fp32 actor leaves
    and fp32 or bf16 ref leaves equals the JAX package's
    `eta * a + (1 - eta) * b` cast to the ref's dtype, bit for bit."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    a = {k: rng.standard_normal((64, 48)).astype(np.float32) for k in ("w", "v")}
    b = {k: rng.standard_normal((64, 48)).astype(np.float32) for k in ("w", "v")}
    tdt = getattr(torch, ref_dtype)
    worker = object.__new__(tworker.ModelWorker)
    worker.models = {
        "actor": model_api.Model("actor", _Params({k: torch.from_numpy(v) for k, v in a.items()}),
                                 None, None),
        "ref": model_api.Model("ref", _Params({k: torch.from_numpy(v).to(tdt) for k, v in b.items()}),
                               None, None),
    }
    worker._handle_param_sync({"src": "actor", "dst": "ref", "eta": eta})
    jdt = getattr(jnp, ref_dtype)
    for k in a:
        jb = jnp.asarray(b[k]).astype(jdt)
        want = np.asarray((eta * jnp.asarray(a[k]) + (1 - eta) * jb).astype(jdt).astype(jnp.float32))
        got = worker.models["ref"].engine.params[k]
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), want)


def _ref_actor_gap(master):
    w = master.pool.workers[0]
    actor = _flat_numpy(w.models["actor@0"].engine.get_params())
    ref = _flat_numpy(w.models["ref@0"].engine.get_params())
    return max(float(np.abs(actor[k] - ref[k]).max()) for k in actor)


def test_ref_ema_tracks_actor(tmp_path, ckpt):
    """Twin of tests/test_experiments.py:350: with eta 1.0 the ref equals
    the actor after each step; with no EMA it stays frozen and the actor
    drifts from it."""
    same = (ckpt[0], ckpt[0])  # the ref starts as the actor
    with _reward():
        m1, _ = _trial("port", same, tmp_path / "ema", 8, 2, ema=1.0, offload_ref=False,
                       greedy=False)
        m0, _ = _trial("port", same, tmp_path / "frozen", 8, 2, ema=None, offload_ref=False,
                       greedy=False)
    assert _ref_actor_gap(m1) < 1e-5
    assert _ref_actor_gap(m0) > 1e-5


def test_ref_ema_with_offload_matches_jax(tmp_path, ckpt):
    """Twin of tests/test_experiments.py:396 with eta 0.5: the EMA hook
    reloads the offloaded ref and the trailing OffloadHook pushes it back
    to host memory; after each step the ref is exactly
    0.5 * actor + 0.5 * ref_before (held in the port), and after two steps
    the port's ref equals the JAX package's within rtol 1e-4, atol 1e-6."""
    snaps = []
    orig = tworker.ModelWorker._handle_param_sync

    def param_sync(self, req):
        if req["dst"] == "ref@0":
            snaps.append((_flat_numpy(self.models[req["src"]].engine.get_params()),
                          _flat_numpy(self.models[req["dst"]].engine.get_params())))
        out = orig(self, req)
        if req["dst"] == "ref@0":
            snaps[-1] += (_flat_numpy(self.models[req["dst"]].engine.get_params()),)
        return out

    tworker.ModelWorker._handle_param_sync = param_sync
    try:
        with _reward():
            tm, tstats = _trial("port", ckpt, tmp_path / "port", 8, 2)
            jm, jstats = _trial("jax", ckpt, tmp_path / "jax", 8, 2)
    finally:
        tworker.ModelWorker._handle_param_sync = orig
    assert len(snaps) == 2
    for actor, before, after in snaps:
        for k in actor:
            np.testing.assert_array_equal(after[k], 0.5 * actor[k] + (1 - 0.5) * before[k])
    assert tm.pool.workers[0].models["ref@0"].engine._host_offload is not None
    assert jm.pool.workers[0].models["ref@0"].engine._host_offload is not None
    got = _flat_numpy(tm.pool.workers[0].models["ref@0"].engine.get_params())
    jref = jm.pool.workers[0].models["ref@0"].engine.get_params()
    want = {f"{a}.{b}" if isinstance(v, dict) else a: np.asarray(x, np.float32)
            for a, v in jref.items()
            for b, x in (v.items() if isinstance(v, dict) else [(None, v)])}
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    _assert_stats_close(tstats, jstats, rtol=1e-4, atol=1e-6)


# ---------------- the difficulty filter ----------------


def test_difficulty_filter_matches_jax(tmp_path, ckpt):
    """Twin of tests/test_experiments.py:183: the math reward over the
    same checkpoint (every response wrong, accuracy 0), min_accuracy 0.5,
    max_filter_percentage 0.5, the ref offloaded: the same ids removed in
    the same order, the datasets shrunk alike, the ref left on host."""
    def run(pkg):
        return _trial(pkg, ckpt, tmp_path / pkg, 8, 2, reward=None, ema=None,
                      dataset_filter={"min_accuracy": 0.5, "max_accuracy": 1.0},
                      dataset_args={"max_filter_percentage": 0.5})

    (tm, tstats), (jm, jstats) = run("port"), run("jax")
    assert tm._filtered_ids == jm._filtered_ids and len(tm._filtered_ids) >= 4
    tds, jds = tm.pool.workers[0].datasets[0], jm.pool.workers[0].datasets[0]
    assert tds.ids == jds.ids and len(tds) < 8
    assert tm.pool.workers[0].models["ref@0"].engine._host_offload is not None
    _assert_stats_close(tstats, jstats, rtol=1e-4, atol=1e-6)


# ---------------- kill-and-resume ----------------

_FILTER = {"min_accuracy": 0.25, "max_accuracy": 0.75}


@contextlib.contextmanager
def _one_thread():
    """One torch thread: the CPU's multi-threaded kernels reduce in an
    order that varies from run to run, which two runs compared bit for
    bit cannot allow."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _resume(pkg, ckpt, root, n_rows, restart_after, total, **kw):
    """A trial killed after `restart_after` steps (a recover checkpoint
    each step) and rerun with the same fileroot and trial name to step
    `total`; returns (the first run's master, the resumed run's master
    and stats)."""
    m1, _ = _trial(pkg, ckpt, root, n_rows, restart_after, trial="killed", ckpt_freq=1, **kw)
    m2, stats = _trial(pkg, ckpt, root, n_rows, total, trial="killed", **kw)
    return m1, m2, stats


def test_kill_and_resume_matches_uninterrupted(tmp_path, ckpt):
    """GRPO with a ref (EMA 0.5, offloaded), the difficulty filter and
    sampled responses (seeded by the generator's version): a trial
    restarted after step 1 runs steps 2 and 3 with the uninterrupted
    trial's tokens, its stats within 1e-6 and, at the end, its weights,
    Adam state, ref, filtered ids and versions.  The first batch's
    prompts all have mixed groups, so the filter first drops prompts at
    step 2, after the restart (see the next test for a drop before it)."""
    mixed = _first_batch_ids(12)
    with _one_thread(), _reward(mixed=mixed) as seen:
        mu, ustats = _trial("port", ckpt, tmp_path / "u", 12, 3, greedy=False,
                            dataset_filter=_FILTER)
        useen = list(seen["port"])
        seen["port"].clear()
        m1, m2, rstats = _resume("port", ckpt, tmp_path / "r", 12, 1, 3, greedy=False,
                                 dataset_filter=_FILTER)
        rseen = list(seen["port"])
    assert m1._filtered_ids == [] and m2.step_info == mu.step_info
    assert len(useen) == 3 and len(rseen) == 3 and len(rstats) == 2
    for step, ((uids, utoks), (rids, rtoks)) in enumerate(zip(useen, rseen)):
        assert uids == rids, step
        np.testing.assert_array_equal(utoks, rtoks, err_msg=f"step {step + 1}")
    _assert_stats_close(rstats, ustats[1:], rtol=1e-6)
    assert m2._filtered_ids == mu._filtered_ids and m2._filtered_ids
    uw, rw = mu.pool.workers[0], m2.pool.workers[0]
    assert uw.datasets[0].ids == rw.datasets[0].ids
    assert {k: m.version for k, m in uw.models.items()} == {
        k: m.version for k, m in rw.models.items()}
    ua, ra = uw.models["actor@0"].engine, rw.models["actor@0"].engine
    assert ua.opt_count == ra.opt_count == 6  # two minibatches a step
    for tree in ("params", "_mu", "_nu"):
        for (n, x), (_, y) in zip(ttrain._leaves(getattr(ua, tree)),
                                  ttrain._leaves(getattr(ra, tree))):
            assert torch.equal(x, y), (tree, n)
    for (n, x), (_, y) in zip(ttrain._leaves(uw.models["ref@0"].engine.get_params()),
                              ttrain._leaves(rw.models["ref@0"].engine.get_params())):
        assert torch.equal(x, y), n


def test_kill_and_resume_matches_jax(tmp_path, ckpt):
    """The same restart (greedy) through both packages: the resumed
    trials' tokens are equal, their stats within rtol 1e-4, atol 1e-6,
    the recover checkpoint of each package validates in the other, and
    both drop the same ids."""
    mixed = _first_batch_ids(12)
    runs = {}
    with _reward(mixed=mixed) as seen:
        for pkg in ("jax", "port"):
            runs[pkg] = _resume(pkg, ckpt, tmp_path / pkg, 12, 1, 3, dataset_filter=_FILTER)
        for (tids, ttoks), (jids, jtoks) in zip(seen["port"], seen["jax"]):
            assert tids == jids
            np.testing.assert_array_equal(ttoks, jtoks)
        assert len(seen["port"]) == len(seen["jax"]) == 3
    _assert_stats_close(runs["port"][2], runs["jax"][2], rtol=1e-4, atol=1e-6)
    assert runs["port"][1]._filtered_ids == runs["jax"][1]._filtered_ids
    for pkg, mod in (("port", jrecover), ("jax", recover)):
        base = runs[pkg][0]._ckpt_dir(runs[pkg][0]._train_rpcs[0], "recover_checkpoint")
        manifest = mod.validate_manifest(base)
        assert manifest is not None and manifest["step"] == 1, pkg
        assert manifest["model_versions"] == {"actor@0": 1}


def test_restart_after_a_filter_drop_replays_the_shrunken_order(tmp_path, ckpt):
    """A behaviour of the reference, pinned in both packages: when the
    filter drops prompts before a recover checkpoint, the restarted
    trial rewinds its data cursor by replaying batches of a permutation
    drawn over the SHRUNKEN dataset, so its next batches differ from the
    uninterrupted trial's (which kept the epoch's first permutation).
    Both packages' resumed trials agree: the same ids and tokens, stats
    within rtol 1e-4, atol 1e-6."""
    runs = {}
    with _reward() as seen:
        mu, _ = _trial("port", ckpt, tmp_path / "u", 12, 2, dataset_filter=_FILTER)
        useen = list(seen["port"])
        seen["port"].clear()
        for pkg in ("jax", "port"):
            runs[pkg] = _resume(pkg, ckpt, tmp_path / pkg, 12, 1, 2, dataset_filter=_FILTER)
        for (tids, ttoks), (jids, jtoks) in zip(seen["port"], seen["jax"]):
            assert tids == jids
            np.testing.assert_array_equal(ttoks, jtoks)
    assert runs["port"][0]._filtered_ids == runs["jax"][0]._filtered_ids != []
    assert useen[0][0] == seen["port"][0][0]  # the same first step
    assert useen[1][0] != seen["port"][1][0]  # the second step's batch shifted
    _assert_stats_close(runs["port"][2], runs["jax"][2], rtol=1e-4, atol=1e-6)


def test_restart_at_step_2_rebuilds_the_ema_ref(tmp_path, ckpt):
    """A behaviour of the reference, pinned in both packages: no recover
    checkpoint holds the EMA reference model (it is not a train node);
    the restore rebuilds it by replaying the actor's post-hooks on the
    ref's initial weights.  So after a restart at step 2 the ref is
    eta * actor_2 + (1 - eta) * ref_0 (exactly, in the port), not the
    uninterrupted trial's ref_2; both packages' restored refs agree
    within rtol 1e-4, atol 1e-6."""
    refs = {}
    with _reward():
        mu, _ = _trial("port", ckpt, tmp_path / "u", 12, 2)
        for pkg in ("jax", "port"):
            _, m2, stats = _resume(pkg, ckpt, tmp_path / pkg, 12, 2, 2)
            assert stats == []  # restored at step 2 of 2: nothing left to run
            w = m2.pool.workers[0]
            refs[pkg] = (_flat_numpy(w.models["ref@0"].engine.get_params()),
                         _flat_numpy(w.models["actor@0"].engine.get_params()))
    ref, actor = refs["port"]
    from areal_tpu_torch.models.hf import registry as hf

    # The ref's initial weights as the worker loads them (the config's
    # dtype), in the CPU engine's fp32.
    _, ref0 = hf.load_hf_checkpoint(ckpt[1], device="cpu")
    ref0 = _flat_numpy(ref0)
    uref = _flat_numpy(mu.pool.workers[0].models["ref@0"].engine.get_params())
    for k in ref:
        want = (torch.tensor(0.5) * torch.from_numpy(actor[k])
                + torch.tensor(0.5) * torch.from_numpy(ref0[k])).numpy()
        np.testing.assert_array_equal(ref[k], want, err_msg=k)
        np.testing.assert_allclose(ref[k], refs["jax"][0][k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert max(float(np.abs(ref[k] - uref[k]).max()) for k in ref) > 1e-4


# ---------------- quarantine rollback ----------------


def test_quarantine_rollback_recovers_like_jax(tmp_path, ckpt):
    """NaN rewards at the second reward call quarantine step 2 (the
    update is discarded); with max_consecutive_quarantines 1 the master
    rolls back to the step-1 recover checkpoint and replays step 2, which
    then runs clean: four steps of stats for three steps of progress,
    the same in both packages (stats within rtol 1e-4, atol 1e-6), the
    ledger holding step 1's entry."""
    out = {}
    with _reward(nan_calls={2}) as seen:
        for pkg in ("jax", "port"):
            out[pkg] = _trial(pkg, ckpt, tmp_path / pkg, 12, 3, ckpt_freq=1, mcq=1)
        assert [ids for ids, _ in seen["port"]] == [ids for ids, _ in seen["jax"]]
    (tm, tstats), (jm, jstats) = out["port"], out["jax"]
    assert [s["actor_train/quarantined"] for s in tstats] == [
        s["actor_train/quarantined"] for s in jstats] == [0.0, 1.0, 0.0, 0.0]
    assert tm.step_info.global_step == jm.step_info.global_step == 3
    assert tm._recoveries == jm._recoveries == 1
    assert [e["step"] for e in tm._quarantine_ledger] == [
        e["step"] for e in jm._quarantine_ledger] == [1]
    assert list(tm._quarantine_ledger[0]["kinds"]) == ["nonfinite"]
    assert tm.pool.workers[0].models["actor@0"].engine.opt_count == 6
    _assert_stats_close(tstats, jstats, rtol=1e-4, atol=1e-6)


def test_quarantine_budget_exhausted_raises_like_jax(tmp_path, ckpt):
    """NaN rewards from the second call on: every replay of step 2 is
    quarantined again; with max_recoveries 1 the second rollback raises
    in both packages."""
    with _reward(nan_calls=set(range(2, 20))):
        for pkg in ("jax", "port"):
            with pytest.raises(RuntimeError, match=r"recovery budget exhausted \(1\)"):
                _trial(pkg, ckpt, tmp_path / pkg, 12, 3, ckpt_freq=1, mcq=1, max_recoveries=1)
            assert _REWARD["calls"][pkg] == 3, pkg
