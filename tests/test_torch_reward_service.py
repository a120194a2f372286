"""The port's reward service against the JAX package's: `grade_item`
gives the JAX package's grade on math, code and judge items (the opaque
schema and the older flat one); the port's service answers the JAX
package's `post_verify` and the JAX service the port's (one wire
format); `RemoteVerifier` falls back to local grading with the service
down and counts each failure by reason; the reward interface grades
through `remote_url` exactly as in-process, code rows included;
`RewardFabric`; the verifier CLI (alone and as a fleet member); the
reward interface's `verifier_pool` (refused without a fleet to discover,
as in the JAX package); and the sandbox's program unaffected
by a process forked beside it (the sympy pool's fork).

The JAX package's service is sent code items one batch at a time only:
grading math (a forked sympy worker) and code (a program on pipes) at
once in its process can hold a program's stdin open until its timeout
(the race the port's sandbox avoids with files)."""

import json

import numpy as np
import pytest

from areal_tpu.interfaces import reward_service as jrs
from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model_api import Model
from areal_tpu_torch.base import metrics
from areal_tpu_torch.data.tokenizer import CharTokenizer
from areal_tpu_torch.interfaces import reward_service as trs
from areal_tpu_torch.interfaces.reward import MultiTaskRewardInterface
from areal_tpu_torch.system.episode import RewardFabric

ECHO = "```python\nprint(input())\n```"
IO = json.dumps({"inputs": ["hi", "7"], "outputs": ["hi", "7"]})

ITEMS = [
    {"task": "math", "text": r"the answer is \boxed{\frac{1}{2}}",
     "payload": {"solutions": [r"\boxed{0.5}"]}},
    {"task": "math", "text": r"\boxed{3}", "payload": {"solutions": [r"\boxed{4}"]}},
    {"task": "math", "text": "so (B)", "payload": {"solutions": ["B"], "choices": ["x", "y"]}},
    {"task": "code", "text": ECHO, "payload": {"input_output": IO, "timeout_s": 20.0}},
    {"task": "code", "text": "```python\nprint('no')\n```",
     "payload": {"input_output": IO, "timeout_s": 20.0}},
    {"task": "code", "text": "no fence here", "payload": {"input_output": IO}},
    {"task": "judge", "text": "... Final: Paris", "payload": {"reference": "paris"}},
    {"task": "judge", "text": "Paris is long ago; final: Rome",
     "payload": {"reference": "paris", "tail_chars": 10}},
    {"task": "judge", "text": "anything", "payload": {}},
    {"task": "no-such-task", "text": "x", "payload": {}},
    # The flat schema: backend keys at the top level.
    {"task": "math", "text": r"\boxed{7}", "solutions": [r"\boxed{7}"]},
]


@pytest.fixture(scope="module")
def services():
    t = trs.serve("127.0.0.1", 0, background=True)
    j = jrs.serve("127.0.0.1", 0, background=True)
    yield f"http://127.0.0.1:{t.server_port}", f"http://127.0.0.1:{j.server_port}"
    for s in (t, j):
        s.shutdown()
        s.server_close()


@pytest.mark.parametrize("i", range(len(ITEMS)))
def test_grade_item_matches_jax(i):
    assert trs.grade_item(ITEMS[i]) == jrs.grade_item(ITEMS[i])


def test_grades_are_the_expected_ones():
    assert [trs.grade_item(it) for it in ITEMS] == [
        True, False, True, True, False, False, True, False, False, False, True]
    assert trs.verifier_names() == ["code", "judge", "math"]


@pytest.mark.parametrize("client,server", [("jax", "port"), ("port", "jax"), ("port", "port")])
def test_one_wire_format(services, client, server):
    url = services[0] if server == "port" else services[1]
    post = {"jax": jrs.post_verify, "port": trs.post_verify}[client]
    want = [jrs.grade_item(it) for it in ITEMS]
    if server == "jax":  # the code items alone, then the rest
        code = [i for i, it in enumerate(ITEMS) if it["task"] == "code"]
        rest = [i for i in range(len(ITEMS)) if i not in code]
        for idx in (code, rest):
            assert post(url, [ITEMS[i] for i in idx], timeout_s=120.0) == [want[i] for i in idx]
    else:
        assert post(url, ITEMS, timeout_s=120.0) == want


def test_health_and_errors(services):
    import urllib.error
    import urllib.request

    with urllib.request.urlopen(services[0] + "/health", timeout=30) as r:
        assert json.loads(r.read()) == {"status": "ok"}
    req = urllib.request.Request(services[0] + "/verify", data=b"{}",
                                 headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 500


def test_token_is_required_when_set():
    srv = trs.serve("127.0.0.1", 0, background=True, token="s3cret")
    url = f"http://127.0.0.1:{srv.server_port}"
    try:
        import urllib.error

        with pytest.raises(urllib.error.HTTPError):
            trs.post_verify(url, ITEMS[:1], timeout_s=30.0)
        assert trs.post_verify(url, ITEMS[:1], timeout_s=30.0, token="s3cret") == [True]
    finally:
        srv.shutdown()
        srv.server_close()


def _errors(reason):
    m = metrics.default_registry().get("areal_reward_remote_errors_total")
    return m.labels(reason).get()


def test_fallback_with_the_service_down():
    before = _errors("network")
    v = trs.RemoteVerifier("http://127.0.0.1:1", timeout_s=0.5, attempts=2, backoff_s=0.0)
    assert v.verify_batch(ITEMS[:3]) == [True, False, True]
    assert _errors("network") - before == 2 and v._degraded
    with pytest.raises(ValueError):
        trs.RemoteVerifier("http://x", attempts=0)


def test_shape_mismatch_is_typed_and_falls_back(monkeypatch):
    v = trs.RemoteVerifier("http://127.0.0.1:1", attempts=1)
    monkeypatch.setattr(trs, "post_verify", lambda *a, **k: (_ for _ in ()).throw(
        trs.VerifierShapeError("short")))
    before = _errors("shape")
    assert v.verify_batch(ITEMS[:2]) == [True, False]
    assert _errors("shape") - before == 1


def _rollout(tok, rows, responses):
    """A rollout sample: each row's prompt then its group's responses."""
    toks, pmask, ids, seqlens = [], [], [], []
    for row, group in zip(rows, responses):
        ids.append(row["query_id"])
        p = tok.encode(row["prompt"])
        lens = []
        for text in group:
            r = tok.encode(text)
            toks += p + r
            pmask += [1] * len(p) + [0] * len(r)
            lens.append(len(p) + len(r))
        seqlens.append(lens)
    return SequenceSample(
        keys={"packed_input_ids", "prompt_mask"}, ids=ids,
        seqlens={"packed_input_ids": seqlens, "prompt_mask": seqlens},
        data={"packed_input_ids": np.asarray(toks, np.int32),
              "prompt_mask": np.asarray(pmask, np.bool_)},
    )


def test_reward_interface_remote_equals_in_process(services):
    tok = CharTokenizer(512)
    rows = [
        {"query_id": "m0", "prompt": "1+1? ", "task": "math", "solutions": [r"\boxed{2}"]},
        {"query_id": "c0", "prompt": "echo: ", "task": "code", "input_output": IO},
        {"query_id": "j0", "prompt": "capital? ", "task": "judge", "reference": "Paris"},
    ]
    sample = _rollout(tok, rows, [[r"\boxed{2}", r"\boxed{3}"], [ECHO, "print(1)"],
                                  ["It is Paris", "Rome"]])
    model = Model(name="reward", engine=None, tokenizer=tok, config=None)
    id2info = {r["query_id"]: r for r in rows}
    local = MultiTaskRewardInterface(id2info=id2info, code_timeout_s=20.0).inference(
        model, sample, MicroBatchSpec())
    remote = MultiTaskRewardInterface(id2info=id2info, code_timeout_s=20.0, remote_timeout_s=120.0,
                                      remote_url=services[0]).inference(model, sample,
                                                                         MicroBatchSpec())
    np.testing.assert_array_equal(remote.data["rewards"], local.data["rewards"])
    assert local.data["rewards"].tolist() == [5.0, -5.0, 5.0, -5.0, 5.0, -5.0]
    forced = MultiTaskRewardInterface(id2info=id2info, reward_backend="judge").inference(
        model, sample, MicroBatchSpec())
    assert forced.data["rewards"].tolist() == [-5.0] * 4 + [5.0, -5.0]


def test_verifier_pool_is_refused():
    """`verifier_pool=True` without the experiment and trial whose fleet
    it discovers is refused at its first grade, with the JAX package's
    message; the interface itself constructs (its pool client is built
    at first use).  Grading through a fleet: tests/test_torch_verifier_pool.py."""
    from areal_tpu.interfaces.reward import MultiTaskRewardInterface as JReward

    tok = CharTokenizer(512)
    rows = [{"query_id": "m0", "prompt": "1+1? ", "task": "math", "solutions": [r"\boxed{2}"]}]
    sample = _rollout(tok, rows, [[r"\boxed{2}"]])
    model = Model(name="reward", engine=None, tokenizer=tok, config=None)
    port = MultiTaskRewardInterface(id2info={"m0": rows[0]}, verifier_pool=True)
    with pytest.raises(ValueError, match="needs pool_experiment and pool_trial") as got:
        port.inference(model, sample, MicroBatchSpec())
    with pytest.raises(ValueError) as want:
        JReward(verifier_pool=True)._verifier_pool()
    assert str(got.value) == str(want.value)


def test_reward_fabric(services):
    seen = []
    local = RewardFabric(on_result=lambda task, ok: seen.append((task, ok)))
    remote = RewardFabric(remote=trs.RemoteVerifier(services[0], timeout_s=120.0), max_workers=2)
    try:
        # The JAX grades first: its sympy pool forks this process, which
        # must not overlap the port's subprocess spawns.
        want = [jrs.grade_item(it) for it in ITEMS[:9]]
        futs = [local.submit(it["task"], it["text"], it["payload"]) for it in ITEMS[:9]]
        assert [f.result(timeout=120) for f in futs] == want
        assert sorted(seen) == sorted((it["task"], w) for it, w in zip(ITEMS[:9], want))
        assert remote.grade("code", ECHO, {"input_output": IO}, timeout_s=120) is True
        assert remote.grade("math", r"\boxed{1}", {"solutions": ["2"]}, timeout_s=120) is False
    finally:
        local.close()
        remote.close()


def test_verifier_cli(monkeypatch):
    from areal_tpu_torch.apps import verifier

    got = {}
    verifier.main(["--port", "0", "--token", "t", "--max-workers", "3"],
                  serve=lambda host, port, **kw: got.update(host=host, port=port, **kw))
    assert got == {"host": "127.0.0.1", "port": 0, "token": "t", "max_workers": 3}
    got.clear()
    verifier.main([], serve=lambda host, port, **kw: got.update(host=host, port=port, **kw))
    assert got["port"] == 8090
    # A fleet member (run to its end: an already-due kill crashes it at
    # once, its key left to the TTL): --experiment and --trial announce it.
    from areal_tpu_torch.base import name_resolve, names, tracer

    monkeypatch.setenv("AREAL_FAULTS", "kill@t=0s")
    tracer._reset_for_tests()
    worker = verifier.main(["--experiment", "e-cli", "--trial", "t", "--server-id", "v9",
                            "--ttl", "30"], serve=None)
    tracer._reset_for_tests()
    assert worker._crashed
    key = names.verifier_server("e-cli", "t", "v9")
    assert name_resolve.get(key) == worker.url
    name_resolve.delete(key)
    for bad in (["--trial", "t"], ["--experiment", "e"]):
        with pytest.raises(SystemExit):
            verifier.main(bad, serve=lambda *a, **k: None)


def test_sandbox_ignores_a_concurrent_fork(monkeypatch):
    """A process forked beside a sandboxed program (as the sympy pool's
    worker is, lazily, from another grading thread) inherits this
    process's open descriptors.  Forked while Popen still holds the
    child's ends, it would keep a stdout pipe's write end open, and the
    call would wait for an EOF until its timeout.  The fork is placed in
    that window here; through files the program's output comes at once."""
    import multiprocessing
    import subprocess
    import sys
    import time

    from areal_tpu_torch.interfaces.sandbox import run_sandboxed

    ctx = multiprocessing.get_context("fork")
    sleepers = []
    real_close = subprocess.Popen._close_pipe_fds

    def close_after_a_fork(self, *fds):
        p = ctx.Process(target=time.sleep, args=(8.0,))
        p.start()
        sleepers.append(p)
        return real_close(self, *fds)

    monkeypatch.setattr(subprocess.Popen, "_close_pipe_fds", close_after_a_fork)
    try:
        t0 = time.monotonic()
        rc, out = run_sandboxed([sys.executable, "-c", "print(input())"], input_text="hi",
                                timeout_s=5.0)
        took = time.monotonic() - t0
    finally:
        monkeypatch.undo()
        for p in sleepers:
            p.kill()
            p.join(timeout=30)
    assert sleepers and (rc, out.strip()) == (0, "hi") and took < 5.0


def test_sympy_pool_never_forks_this_process(monkeypatch):
    """The sympy layer's worker pool starts from a fork server: no
    os.fork of this threaded process, which could copy a concurrent
    subprocess spawn's error pipe (the sandbox's) and stall that spawn."""
    import os

    from areal_tpu_torch.interfaces import math_sympy

    math_sympy._kill_executor()

    def no_fork():
        raise AssertionError("the sympy pool forked this process")

    monkeypatch.setattr(os, "fork", no_fork)
    try:
        assert math_sympy.answers_match_sympy("1/2", "0.5", timeout=60.0)
        assert not math_sympy.answers_match_sympy("1/3", "0.5", timeout=60.0)
    finally:
        monkeypatch.undo()
        math_sympy._kill_executor()


def test_trial_grades_through_remote_url(services, tmp_path, monkeypatch):
    """A ppo-math trial built through build_ppo_math with
    reward_interface_args["remote_url"]: every batch is graded by the
    service (its handler grades each item), and the rewards equal the
    in-process interface's on the same rows."""
    from areal_tpu_torch.api.config import ModelAbstraction
    from areal_tpu_torch.api.data_api import DatasetAbstraction
    from areal_tpu_torch.api.model_api import GenerationHyperparameters, OptimizerConfig
    from areal_tpu_torch.experiments import common as exps
    from areal_tpu_torch.models.config import tiny_config
    from tests import fixtures

    rows = fixtures.build_math_rows(8, seed=4)
    graded, compared = [], []
    real_grade = trs.grade_item
    monkeypatch.setattr(trs, "grade_item", lambda it: graded.append(it) or real_grade(it))
    real_inference = MultiTaskRewardInterface.inference

    def inference(self, model, sample, mb_spec):
        out = real_inference(self, model, sample, mb_spec)
        local = real_inference(MultiTaskRewardInterface(id2info=self.id2info), model, sample,
                               mb_spec)
        compared.append(np.array_equal(out.data["rewards"], local.data["rewards"]))
        return out

    monkeypatch.setattr(MultiTaskRewardInterface, "inference", inference)
    cfg = exps.PPOMathConfig(
        actor=ModelAbstraction("random", {"config": tiny_config()}),
        dataset=DatasetAbstraction(
            "math_code_prompt", {"dataset_builder": lambda: rows, "max_length": 64}),
        reward_interface_args={"id2info": {r["query_id"]: r for r in rows},
                               "remote_url": services[0]},
        gconfig=GenerationHyperparameters(n=2, max_new_tokens=8),
        ppo_kwargs={"n_minibatches": 1},
        optimizer=OptimizerConfig(lr=1e-3, warmup_steps_proportion=0.0),
        batch_size=4, fileroot=str(tmp_path),
    )
    tok = CharTokenizer(512)
    master, stats = exps.run_experiment(exps.build_ppo_math(cfg, tok), tokenizer=tok,
                                        device="cpu")
    assert len(stats) == 2 and compared == [True, True]
    # The service graded each step's 8 responses; the in-process
    # comparison graded its own 8 (the fallback never ran).
    assert len(graded) == 2 * (8 + 8)
    assert master.pool.workers[0].interfaces["reward@0"].remote_url == services[0]
