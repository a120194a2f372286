"""The port's `trace_report` (`areal_tpu_torch/apps/trace_report.py`)
against the JAX package's on the same merged traces: twins of
tests/test_tracer.py's attribution cases, then seeded random traces
(several processes, step windows, categorized spans, the streamed
step's ``pipe:*`` spans, MFC spans with profile args, lineage with
orphans, failures and stale rejections) through attribution, bubbles,
pipeline rows, lineage rows and summary, the flight view, every text
view, the JSON report and the CLI.  Last, a traced tiny ``ppo-math``
trial with a window-2 streamed step in each package: the same span
names and categories in each process, the same ``--pipeline`` rows,
and in the port the untraced trial's stats bit for bit."""

import json
import os

import numpy as np
import pytest
import torch

from areal_tpu.apps import trace_report as jreport
from areal_tpu.base import tracer as jtracer
from areal_tpu_torch.apps import trace_report
from areal_tpu_torch.base import tracer

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _fresh_tracer():
    tracer._reset_for_tests()
    jtracer._reset_for_tests()
    yield
    tracer._reset_for_tests()
    jtracer._reset_for_tests()


def _synthetic_trace():
    """One step window [0, 100] ms on pid 1: compute 0-40, comms 30-50
    (the overlap yields to comms), host 60-70, so 40 ms idle."""
    ms = 1000
    return {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 1, "tid": 0, "ts": 0,
         "args": {"name": "worker_0"}},
        {"ph": "X", "name": "step", "ts": 0, "dur": 100 * ms, "pid": 1, "tid": 1,
         "args": {"step": 3}},
        {"ph": "X", "name": "mfc", "cat": "compute", "ts": 0, "dur": 40 * ms, "pid": 1, "tid": 1},
        {"ph": "X", "name": "xfer", "cat": "comms", "ts": 30 * ms, "dur": 20 * ms, "pid": 1,
         "tid": 1},
        {"ph": "X", "name": "load", "cat": "host", "ts": 60 * ms, "dur": 10 * ms, "pid": 1,
         "tid": 1},
    ]}


def test_attribution_buckets_and_precedence():
    rows = trace_report.attribute(_synthetic_trace())
    assert len(rows) == 1
    r = rows[0]
    assert r["step"] == 3 and r["process"] == "worker_0" and r["window_us"] == 100_000
    assert (r["comms_us"], r["compute_us"], r["host_us"], r["idle_us"]) == (
        20_000, 30_000, 10_000, 40_000)


def test_bubbles_report_largest_gaps():
    bubs = trace_report.bubbles(_synthetic_trace(), top=5)
    assert (bubs[0]["dur_us"], bubs[0]["after_span"], bubs[0]["before_span"]) == (
        30_000, "load", None)
    assert (bubs[1]["dur_us"], bubs[1]["after_span"], bubs[1]["before_span"]) == (
        10_000, "xfer", "load")


def test_format_report_renders():
    out = trace_report.format_report(_synthetic_trace())
    assert "worker_0" in out and "idle" in out and "bubbles" in out


# ---------------- seeded traces, both packages ----------------


def _random_trace(seed):
    rng = np.random.default_rng(seed)
    evs = []
    n_proc = int(rng.integers(1, 4))
    for pid in range(1, n_proc + 1):
        evs.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0, "ts": 0,
                    "args": {"name": ["master_0", "worker_1", "gen_server_8101"][pid - 1]}})
    n_steps = int(rng.integers(0, 4))
    t = 0
    for step in range(1, n_steps + 1):
        dur = int(rng.integers(50_000, 200_000))
        args = {"step": step} if rng.random() < 0.9 else {}
        evs.append({"ph": "X", "name": "step", "ts": t, "dur": dur, "pid": 1, "tid": 1,
                    "args": args})
        for stage in ("actor_gen", "rew_inf", "actor_train"):
            for chunk in range(int(rng.integers(0, 3))):
                s = t + int(rng.integers(0, dur))
                evs.append({"ph": "X", "name": f"pipe:{stage}", "ts": s,
                            "dur": int(rng.integers(1, dur // 2)), "pid": 1, "tid": 1,
                            "args": {"stage": stage, "chunk": chunk, "n": 2}})
        t += dur + int(rng.integers(0, 20_000))
    horizon = max(t, 100_000)
    cats = ["compute", "comms", "host", None]
    for pid in range(1, n_proc + 1):
        for _ in range(int(rng.integers(3, 15))):
            cat = cats[int(rng.integers(0, 4))]
            ev = {"ph": "X", "name": f"span{int(rng.integers(0, 6))}", "ts": int(
                rng.integers(0, horizon)), "dur": int(rng.integers(1, horizon // 3)),
                "pid": pid, "tid": int(rng.integers(1, 3))}
            if cat:
                ev["cat"] = cat
            evs.append(ev)
        for _ in range(int(rng.integers(0, 4))):
            mfc = ["actor@0:generate", "actor@0:train_step", "ref@0:inference"][
                int(rng.integers(0, 3))]
            evs.append({"ph": "X", "name": f"mfc:{mfc}", "cat": "compute",
                        "ts": int(rng.integers(0, horizon)),
                        "dur": int(rng.integers(100, 50_000)), "pid": pid, "tid": 2,
                        "args": {"mfc": mfc, "tokens": int(rng.integers(10, 900)),
                                 "seqs": int(rng.integers(1, 9)),
                                 "tflops": float(rng.uniform(0, 2)),
                                 "mfu": float(rng.uniform(0, 1)), "layout": "d1",
                                 "model_shape": "l2h64q4kv2v512"}})
        evs.append({"ph": "X", "name": "xfer:data", "cat": "comms",
                    "ts": int(rng.integers(0, horizon)), "dur": 500, "pid": pid, "tid": 1,
                    "args": {"mfc": "actor@0:train_step", "bytes": int(rng.integers(1, 10**6))}})
        evs.append({"ph": "C", "name": "kv_pool", "ts": int(rng.integers(0, horizon)),
                    "pid": pid, "tid": 0, "args": {"live_tokens": 3}})
    for k in range(int(rng.integers(0, 8))):
        tid = f"tr-{seed:04d}{k:04d}"
        stages = ["dispatch", "first_token", "generated", "graded", "admitted", "trained"]
        cut = int(rng.integers(1, len(stages) + 1))
        ts = int(rng.integers(0, horizon))
        for i, stage in enumerate(stages[:cut]):
            a = {"trace_id": tid, "stage": stage}
            if stage == "dispatch":
                if rng.random() < 0.85:
                    a["root"] = True
                a["qid"] = f"q{k}"
                if rng.random() < 0.5:
                    a["task"] = ["math", "code"][int(rng.integers(0, 2))]
            if stage == "admitted":
                a["version_lag"] = int(rng.integers(0, 3))
            ts += int(rng.integers(1, 20_000))
            evs.append({"ph": "i", "name": f"lineage:{stage}", "cat": "lineage", "ts": ts,
                        "pid": int(rng.integers(1, n_proc + 1)), "tid": 1, "s": "t",
                        "args": a})
        if cut < 3 and rng.random() < 0.5:
            stage = ["failed", "rejected_stale"][int(rng.integers(0, 2))]
            evs.append({"ph": "i", "name": f"lineage:{stage}", "cat": "lineage",
                        "ts": ts + 1, "pid": 1, "tid": 1, "s": "t",
                        "args": {"trace_id": tid, "stage": stage}})
    return {"traceEvents": evs, "displayTimeUnit": "ms"}


SEEDS = range(10)


@pytest.mark.parametrize("seed", SEEDS)
def test_reports_equal_jax(seed):
    trace = _random_trace(seed)
    for fn in ("attribute", "pipeline_rows", "lineage_rows", "lineage_summary",
               "format_pipeline", "format_lineage", "json_report"):
        got = getattr(trace_report, fn)(json.loads(json.dumps(trace)))
        want = getattr(jreport, fn)(json.loads(json.dumps(trace)))
        assert got == want, fn
    for top in (1, 5, 50):
        assert trace_report.bubbles(trace, top=top) == jreport.bubbles(trace, top=top)
        assert trace_report.format_report(trace, top=top) == jreport.format_report(trace, top=top)
    assert tracer.validate_trace(trace) == jtracer.validate_trace(trace)


@pytest.mark.parametrize("seed", SEEDS)
def test_flight_views_equal_jax(tmp_path, seed):
    rng = np.random.default_rng(seed)
    t0 = 1_700_000_000_000_000
    for k in range(int(rng.integers(1, 4))):
        events = [{"t_us": t0 + int(rng.integers(0, 30_000_000)),
                   "kind": ["dispatch", "span", "kill", "breaker"][int(rng.integers(0, 4))],
                   "qid": f"q{i}", "sid": "s1"} for i in range(int(rng.integers(0, 12)))]
        doc = {"role": ["verifier", "gen_server", "master"][k], "rank": k, "pid": 100 + k,
               "reason": "fault_kill", "t_dump_us": t0 + int(rng.integers(0, 30_000_000)),
               "events": events}
        (tmp_path / f"flightrec_{doc['role']}_{k}.json").write_text(json.dumps(doc))
    for window in (1.0, 10.0, 60.0):
        assert trace_report.format_flight(str(tmp_path), window) == jreport.format_flight(
            str(tmp_path), window)


@pytest.mark.parametrize("view", [[], ["--json"], ["--pipeline"], ["--lineage"], ["--flight"],
                                  ["--top", "2"]])
def test_cli_prints_what_jax_prints(tmp_path, capsys, view):
    trace = _random_trace(3)
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(trace))
    (tmp_path / "flightrec_x_0.json").write_text(json.dumps(
        {"role": "x", "rank": 0, "pid": 1, "reason": "fault_kill", "t_dump_us": 5,
         "events": [{"t_us": 4, "kind": "kill", "port": 1}]}))
    assert trace_report.main([str(path), *view]) == jreport.main([str(path), *view])
    out = capsys.readouterr().out
    half = len(out) // 2
    assert out[:half] == out[half:]


def test_cli_refuses_a_bad_trace(tmp_path, capsys):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({"traceEvents": [{"ph": "Z", "name": "?", "ts": 0, "pid": 1,
                                                 "tid": 1}]}))
    assert trace_report.main([str(path)]) == 1
    assert "trace schema problems" in capsys.readouterr().err


# ---------------- a traced tiny trial in each package ----------------


def _trial(pkg, root, traced, monkeypatch):
    """The tiny ppo-math trial with a window-2 streamed step (two chunks
    of two prompts), in-process, traced or not."""
    from tests import fixtures

    rows = fixtures.build_math_rows(8, seed=4)
    trace_dir = os.path.join(root, "trace")
    if traced:
        monkeypatch.setenv("AREAL_TRACE", "1")
        monkeypatch.setenv("AREAL_TRACE_DIR", trace_dir)
    else:
        monkeypatch.delenv("AREAL_TRACE", raising=False)
        monkeypatch.delenv("AREAL_TRACE_DIR", raising=False)
    common = dict(batch_size=4, total_train_epochs=1, fileroot=str(root),
                  pipeline_overlap=True, overlap_window=2, pipeline_chunk_seqs=2)
    if pkg == "jax":
        from areal_tpu.api.config import ModelAbstraction
        from areal_tpu.api.data_api import DatasetAbstraction
        from areal_tpu.api.model_api import GenerationHyperparameters, OptimizerConfig
        from areal_tpu.experiments import common as exps
        from areal_tpu.models.config import tiny_config
        from areal_tpu.system.master import ExperimentSaveEvalControl

        tok = fixtures.make_tokenizer()
        kw = {}
    else:
        from areal_tpu_torch.api.config import ModelAbstraction
        from areal_tpu_torch.api.data_api import DatasetAbstraction
        from areal_tpu_torch.api.model_api import GenerationHyperparameters, OptimizerConfig
        from areal_tpu_torch.data.tokenizer import CharTokenizer
        from areal_tpu_torch.experiments import common as exps
        from areal_tpu_torch.models.config import tiny_config
        from areal_tpu_torch.system.master import ExperimentSaveEvalControl

        tok = CharTokenizer(512)
        kw = {"device": "cpu"}
    cfg = exps.PPOMathConfig(
        actor=ModelAbstraction("random", {"config": tiny_config()}),
        ref=ModelAbstraction("random", {"config": tiny_config()}),
        dataset=DatasetAbstraction("math_code_prompt",
                                   {"dataset_builder": lambda: rows, "max_length": 64}),
        reward_interface_args={"id2info": {r["query_id"]: r for r in rows}},
        gconfig=GenerationHyperparameters(n=2, max_new_tokens=8),
        ppo_kwargs={"n_minibatches": 2, "kl_ctl": 0.1},
        optimizer=OptimizerConfig(lr=1e-4, warmup_steps_proportion=0.0),
        ctrl=ExperimentSaveEvalControl(benchmark_steps=2), **common,
    )
    (tracer if pkg == "port" else jtracer)._reset_for_tests()
    try:
        stats = exps.run_experiment(exps.build_ppo_math(cfg, tok), tokenizer=tok, **kw)[1]
    finally:
        (tracer if pkg == "port" else jtracer).flush()
        (tracer if pkg == "port" else jtracer)._reset_for_tests()
    return stats, trace_dir


def _names_by_process(trace):
    procs = {e["pid"]: e["args"]["name"] for e in trace["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    out = {}
    for e in trace["traceEvents"]:
        if e["ph"] == "X":
            out.setdefault(procs[e["pid"]], set()).add((e["name"], e.get("cat")))
    return out


def test_traced_trial_matches_jax_and_the_untraced_trial(tmp_path, monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the CPU kernels reduce in one order
    try:
        plain, _ = _trial("port", tmp_path / "plain", False, monkeypatch)
        traced, port_dir = _trial("port", tmp_path / "port", True, monkeypatch)
    finally:
        torch.set_num_threads(threads)
    jax_stats, jax_dir = _trial("jax", tmp_path / "jax", True, monkeypatch)
    assert not (tmp_path / "plain" / "trace").exists()
    # Tracing changes no number of the trial.
    assert len(plain) == len(traced) == 2
    for a, b in zip(plain, traced):
        keys = [k for k in a if "/perf/" not in k and "time" not in k and "pipeline/" not in k]
        assert len(keys) > 10 and {k: a[k] for k in keys} == {k: b[k] for k in keys}
    got = tracer.merge_shards(port_dir)
    want = jtracer.merge_shards(jax_dir)
    assert tracer.validate_trace(got) == [] and jtracer.validate_trace(want) == []
    assert _names_by_process(got) == _names_by_process(want)
    assert ("pipe:actor_train", None) in _names_by_process(got)["master_0"]

    def shape(rows):
        return [(r["step"], [(s["stage"], s["n_chunks"]) for s in r["stages"]]) for r in rows]

    assert shape(trace_report.pipeline_rows(got)) == shape(jreport.pipeline_rows(want))
    assert len(trace_report.pipeline_rows(got)) == 2
    assert len(jax_stats) == 2


@pytest.fixture
def _runtime_env():
    """A multi-process trial points this process at its name-resolve
    store and authkey: later tests get theirs back."""
    from areal_tpu_torch.base import name_resolve
    from areal_tpu_torch.system.stream import ENV_AUTHKEY

    keys = ("AREAL_NAME_RESOLVE", "AREAL_NAME_RESOLVE_ROOT", ENV_AUTHKEY)
    saved = {k: os.environ.get(k) for k in keys}
    default = name_resolve._default
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    name_resolve._default = default


def test_traced_multiprocess_trial_writes_every_process_shard(tmp_path, monkeypatch,
                                                              _runtime_env):
    """AREAL_TRACE=1 with no directory: the master resolves
    ``<fileroot>/logs/<exp>/<trial>/trace`` and exports it, the launcher
    hands it to the worker processes, and each process writes its own
    shard: the master's steps and data-plane spans, each worker's MFC
    compute spans and its transfers, one valid merged trace."""
    from areal_tpu_torch.api.config import ModelAbstraction
    from areal_tpu_torch.api.data_api import DatasetAbstraction
    from areal_tpu_torch.api.model_api import GenerationHyperparameters, OptimizerConfig
    from areal_tpu_torch.apps import main as runner
    from areal_tpu_torch.experiments import common as exps
    from areal_tpu_torch.models.config import tiny_config
    from areal_tpu_torch.system.master import ExperimentSaveEvalControl
    from tests import fixtures

    monkeypatch.setenv("AREAL_TRACE", "1")
    monkeypatch.setenv("AREAL_TRACE_DIR", "")
    rows = fixtures.build_math_rows(8, seed=4)
    data = tmp_path / "math.jsonl"
    data.write_text("".join(json.dumps(r) + "\n" for r in rows))
    cfg = exps.PPOMathConfig(
        actor=ModelAbstraction("random", {"config": tiny_config()}),
        dataset=DatasetAbstraction("math_code_prompt", {"dataset_path": str(data),
                                                        "max_length": 64}),
        gconfig=GenerationHyperparameters(n=2, max_new_tokens=8, greedy=True),
        ppo_kwargs={"n_minibatches": 2},
        optimizer=OptimizerConfig(lr=1e-4, warmup_steps_proportion=0.0),
        batch_size=4, total_train_epochs=1, ctrl=ExperimentSaveEvalControl(benchmark_steps=2),
        placement={"actor_gen": 1, "reward": 1}, fileroot=str(tmp_path / "root"),
        experiment_name="e-mp", trial_name="t-mp",
    )
    plan = exps.build_ppo_math(cfg)
    for wc in plan.worker_configs:
        wc.tokenizer_path = "char:512"
    try:
        stats = runner.run_experiment(plan, device="cpu",
                                      worker_env={"OMP_NUM_THREADS": "1"})
    finally:
        tracer.flush()
        tracer._reset_for_tests()
    assert len(stats) == 2
    trace_dir = tmp_path / "root" / "logs" / "e-mp" / "t-mp" / "trace"
    assert os.environ["AREAL_TRACE_DIR"] == str(trace_dir)
    assert sorted(os.listdir(trace_dir)) == ["trace_master_0.jsonl", "trace_worker_0.jsonl",
                                             "trace_worker_1.jsonl"]
    trace = tracer.merge_shards(str(trace_dir))
    assert tracer.validate_trace(trace) == []
    names = _names_by_process(trace)
    assert {("step", None), ("load_data", "host"), ("xfer:data", "comms"),
            ("param_realloc:actor_gen@0", "comms")} <= names["master_0"]
    assert ("mfc:actor@0:train_step", "compute") in names["worker_0"]
    assert ("mfc:actor_gen@0:generate", "compute") in names["worker_1"]
    assert ("xfer_send", "comms") in names["worker_0"] and ("xfer_recv", "comms") in names[
        "worker_1"]
    rows = trace_report.attribute(trace)
    assert {r["process"] for r in rows} == {"master_0", "worker_0", "worker_1"}
    assert all(r["compute_us"] > 0 for r in rows if r["process"] != "master_0")
