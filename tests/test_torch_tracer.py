"""The port's span tracer (`areal_tpu_torch/base/tracer.py`) against the
JAX package's: twins of tests/test_tracer.py (span nesting and threads,
the mutable args dict, numpy and CPU torch args, the shard's one meta
line, the merge's clock alignment and its tolerance of torn shards, the
schema check, lineage joins and orphans, the always-on flight ring and
its dumps, the replay buffer's lineage stamps, a traced generation
server's spans and gauges); the same script of calls in both packages
under one patched clock writing byte-equal shards and flight dumps,
either package's merge and schema check reading the other's shards,
and both `trace_report.json_report`s equal on a mixed fleet; a device
tensor refused; tracing disabled writing nothing and leaving the
engine's counters as they were; and the replay buffer's stamps with the
JAX buffer's."""

import json
import os
import threading
import time
import types

import jax
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


def _configure(tmp_path, role="test", rank=0, t=tracer):
    t.configure(role=role, rank=rank, dir=str(tmp_path), enabled=True, force=True)


# ---------------- span recording ----------------


def test_disabled_is_noop(tmp_path):
    with tracer.span("x", cat="compute", a=1) as args:
        args["b"] = 2
    assert args == {"a": 1, "b": 2}
    tracer.counter("c", v=1)
    tracer.instant("i")
    tracer.complete("r", start_ns=0)
    assert tracer.flush() is None
    assert list(tmp_path.iterdir()) == []


def test_disabled_span_reads_no_clock(monkeypatch):
    """One bool check and no clock read on the disabled path."""
    def boom():
        raise AssertionError("clock read while disabled")

    monkeypatch.setattr(tracer, "time", types.SimpleNamespace(monotonic_ns=boom, time=boom))
    with tracer.span("x", cat="compute"):
        pass
    tracer.counter("c", v=1)
    tracer.instant("i")
    tracer.complete("r", start_ns=0)


def test_span_nesting_and_mutable_args(tmp_path):
    _configure(tmp_path)
    with tracer.span("outer", cat="host") as oargs:
        with tracer.span("inner", cat="compute", fixed=1) as iargs:
            iargs["late"] = 42
        oargs["bytes"] = 7
    meta, events = tracer.read_shard(tracer.flush())
    assert meta["role"] == "test" and meta["pid"] > 0
    by_name = {e["name"]: e for e in events}
    assert by_name["inner"]["args"] == {"fixed": 1, "late": 42}
    assert by_name["outer"]["args"] == {"bytes": 7}
    o, i = by_name["outer"], by_name["inner"]
    assert o["tid"] == i["tid"] and o["ts"] <= i["ts"]
    assert i["ts"] + i["dur"] <= o["ts"] + o["dur"] + 1


def test_spans_from_threads_get_distinct_tids(tmp_path):
    _configure(tmp_path)
    barrier = threading.Barrier(4)

    def work(n):
        barrier.wait()  # all alive at once: distinct idents
        with tracer.span(f"t{n}"):
            pass

    threads = [threading.Thread(target=work, args=(n,)) for n in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    with tracer.span("main"):
        pass
    _, events = tracer.read_shard(tracer.flush())
    assert {e["name"] for e in events} == {"t0", "t1", "t2", "t3", "main"}
    assert len({e["tid"] for e in events}) == 5


def test_decorator_and_numpy_and_torch_args_serialize(tmp_path):
    _configure(tmp_path)

    @tracer.trace("decorated", cat="host")
    def fn():
        return 3

    assert fn() == 3
    tracer.counter("gauge", v=np.float32(0.5), n=np.int64(3), t=torch.tensor(2.5),
                   a=np.arange(3), ta=torch.arange(2))
    _, events = tracer.read_shard(tracer.flush())
    assert "decorated" in [e["name"] for e in events]
    gauge = next(e for e in events if e["name"] == "gauge")
    assert json.loads(json.dumps(gauge))["args"] == {"v": 0.5, "n": 3.0, "t": 2.5,
                                                     "a": [0, 1, 2], "ta": [0, 1]}


def test_device_tensor_in_args_raises(tmp_path, monkeypatch):
    """Serializing a device tensor would synchronize the device: the
    flush refuses it (a CPU stand-in reports a device other than the
    CPU)."""
    class _OnCard(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    _configure(tmp_path)
    tracer.counter("gauge", v=torch.zeros(()).as_subclass(_OnCard))
    with pytest.raises(TypeError, match="device tensor"):
        tracer.flush()


def test_flush_appends_single_meta(tmp_path):
    _configure(tmp_path)
    with tracer.span("a"):
        pass
    tracer.flush()
    with tracer.span("b"):
        pass
    path = tracer.flush()
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    assert sum(1 for r in rows if r.get("kind") == "meta") == 1
    assert {r["name"] for r in rows if "name" in r} == {"a", "b"}


def test_configure_first_wins_and_default_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("AREAL_TRACE_DIR", "")  # unset, and restored after the test
    monkeypatch.setenv("AREAL_TRACE", "1")
    assert tracer.default_dir(str(tmp_path), "e", "t") == str(tmp_path / "logs/e/t/trace")
    assert os.environ["AREAL_TRACE_DIR"] == str(tmp_path / "logs/e/t/trace")
    assert tracer.configure(role="master") is True
    assert tracer.configure(role="worker", rank=2) is True  # first wins
    assert tracer.shard_path() == str(tmp_path / "logs/e/t/trace/trace_master_0.jsonl")
    monkeypatch.setenv("AREAL_TRACE", "0")
    tracer._reset_for_tests()
    assert tracer.default_dir(str(tmp_path), "e", "t") is None


# ---------------- shard merge and schema ----------------


def _write_two_shards(tmp_path, t=tracer):
    _configure(tmp_path, role="master", rank=0, t=t)
    with t.span("step", step=1):
        with t.span("load_data", cat="host"):
            pass
    t.counter("gen_queue", depth=3)
    t.flush()
    _configure(tmp_path, role="worker", rank=1, t=t)
    with t.span("mfc:actor:train_step", cat="compute", tflops=1.5):
        pass
    t.flush()


def test_merge_shards_perfetto_schema(tmp_path):
    _write_two_shards(tmp_path)
    out = tmp_path / "trace.json"
    trace = tracer.merge_shards(str(tmp_path), out_path=str(out))
    assert tracer.validate_trace(trace) == []
    assert len(json.loads(out.read_text())["traceEvents"]) == len(trace["traceEvents"])
    evs = trace["traceEvents"]
    names = {e["args"]["name"] for e in evs if e["ph"] == "M" and e["name"] == "process_name"}
    assert names == {"master_0", "worker_1"}
    # One process wrote both shards: their meta pids collide, and the
    # merge still gives each its own track.
    assert len({e["pid"] for e in evs if e["ph"] == "M"}) == 2
    assert {"step", "load_data", "mfc:actor:train_step"} <= {e["name"] for e in evs
                                                             if e["ph"] == "X"}
    counters = [e for e in evs if e["ph"] == "C"]
    assert counters and counters[0]["args"] == {"depth": 3}
    assert min(e["ts"] for e in evs if e["ph"] != "M") == 0


def test_merge_tolerates_torn_tail_and_missing_meta(tmp_path):
    (tmp_path / "trace_crashed_9.jsonl").write_text(
        json.dumps({"ph": "X", "name": "partial", "ts": 5, "dur": 2, "tid": 1}) + "\n"
        + '{"ph": "X", "name": "torn'
    )
    trace = tracer.merge_shards(str(tmp_path))
    assert tracer.validate_trace(trace) == []
    spans = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert [s["name"] for s in spans] == ["partial"]
    assert spans[0]["pid"] >= 1 << 20


def test_validate_trace_catches_bad_events():
    bad = {"traceEvents": [
        {"ph": "X", "name": "ok", "ts": 0, "dur": -1, "pid": 1, "tid": 1},
        {"ph": "Z", "name": "?", "ts": 0, "pid": 1, "tid": 1},
    ]}
    errors = tracer.validate_trace(bad)
    assert any("bad dur" in e for e in errors) and any("unknown ph" in e for e in errors)
    assert errors == jtracer.validate_trace(bad)
    assert tracer.validate_trace({"traceEvents": "nope"})


def test_trace_report_main_on_dir(tmp_path, capsys):
    _write_two_shards(tmp_path)
    assert trace_report.main([str(tmp_path)]) == 0
    assert "master_0" in capsys.readouterr().out
    assert (tmp_path / "trace.json").exists()


# ---------------- lineage and the flight recorder ----------------


def _lineage_event(stage, tid, ts, root=False, **args):
    a = {"trace_id": tid, "stage": stage}
    if root:
        a["root"] = True
    a.update(args)
    return {"ph": "i", "name": f"lineage:{stage}", "cat": "lineage", "ts": ts, "pid": 1,
            "tid": 1, "s": "t", "args": a}


def _lineage_fixture(orphan=False):
    ms = 1000
    evs = [
        {"ph": "M", "name": "process_name", "pid": 1, "tid": 0, "ts": 0,
         "args": {"name": "ctl_0"}},
        {"ph": "X", "name": "step", "ts": 0, "dur": 40 * ms, "pid": 1, "tid": 1},
        _lineage_event("dispatch", "tr-good", 0, root=True, qid="q0"),
        _lineage_event("first_token", "tr-good", 5 * ms, qid="q0"),
        _lineage_event("generated", "tr-good", 10 * ms, qid="q0"),
        _lineage_event("graded", "tr-good", 12 * ms, passed=True),
        _lineage_event("admitted", "tr-good", 15 * ms, version_lag=1),
        _lineage_event("trained", "tr-good", 30 * ms),
    ]
    if orphan:
        evs.append(_lineage_event("graded", "tr-orphan", 9 * ms, passed=False))
    return {"traceEvents": evs}


def test_validate_trace_accepts_joined_lineage():
    assert tracer.validate_trace(_lineage_fixture()) == []


def test_validate_trace_rejects_orphan_lineage():
    errors = tracer.validate_trace(_lineage_fixture(orphan=True))
    assert any("orphan" in e and "tr-orphan" in e for e in errors)
    assert errors == jtracer.validate_trace(_lineage_fixture(orphan=True))


def test_lineage_stamps_roundtrip_through_shards(tmp_path):
    _configure(tmp_path, role="ctl", rank=0)
    tid = tracer.new_trace_id()
    assert tid.startswith("tr-") and len(tid) == 19
    with tracer.span("step", step=1):
        tracer.lineage("dispatch", tid, root=True, qid="q0")
        tracer.lineage("trained", tid)
    tracer.flush()
    trace = tracer.merge_shards(str(tmp_path))
    assert tracer.validate_trace(trace) == []
    s = trace_report.lineage_summary(trace)
    assert s["n"] == s["complete"] == 1 and not s["orphans"]


def test_flight_ring_always_on_and_bounded(tmp_path):
    for i in range(600):
        tracer.flight_event("dispatch", qid=f"q{i}")
    tracer.lineage("dispatch", "tr-x", root=True, qid="q600")
    ring = tracer.flight_events()
    assert len(ring) == 512 and ring[0]["qid"] == "q89"
    assert ring[-1]["kind"] == "lineage" and ring[-1]["trace_id"] == "tr-x"
    assert tracer.flush() is None
    assert list(tmp_path.iterdir()) == []


def test_flight_dump_roundtrip_and_report(tmp_path):
    tracer.flight_event("dispatch", trace_id="tr-1", qid="q0", sid="s1")
    tracer.flight_event("kill", port=4242)
    path = tracer.flight_dump("fault_kill", role="gen_server", rank=7, dir=str(tmp_path))
    assert path.endswith("flightrec_gen_server_7.json")
    dumps = tracer.read_flight_dumps(str(tmp_path))
    assert len(dumps) == 1
    d = dumps[0]
    assert d["reason"] == "fault_kill" and d["role"] == "gen_server"
    assert [e["kind"] for e in d["events"]] == ["dispatch", "kill"]
    rendered = trace_report.format_flight(str(tmp_path), window_s=60.0)
    assert "fault_kill" in rendered and "gen_server_7" in rendered
    assert "kill" in rendered and "trace_id=tr-1" in rendered
    assert rendered == jreport.format_flight(str(tmp_path), window_s=60.0)
    (tmp_path / "flightrec_torn_0.json").write_text('{"reason": "x"')
    assert len(tracer.read_flight_dumps(str(tmp_path))) == 1


def test_flight_dump_without_dir_is_noop(monkeypatch):
    monkeypatch.delenv("AREAL_TRACE_DIR", raising=False)
    tracer.flight_event("kill", port=1)
    assert tracer.flight_dump("fault_kill") is None


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_replay_stamps_admission_and_training_lineage(tmp_path, pkg):
    """Both packages' replay buffers, each with its own tracer, stamp the
    same lineage: admitted and trained for a fresh trajectory,
    rejected_stale (never admitted) for a stale one."""
    import time as _time

    if pkg == "port":
        from areal_tpu_torch.system.replay import ReplayBuffer, Trajectory
        t, report = tracer, trace_report
    else:
        from areal_tpu.system.replay import ReplayBuffer, Trajectory
        t, report = jtracer, jreport
    _configure(tmp_path, role="replay", rank=0, t=t)

    def traj(qid, version_start=0):
        tr = Trajectory(qid=qid, prompt_ids=[1, 2], output_ids=[[3, 4]],
                        output_logprobs=[[0.0, 0.0]], no_eos=[False],
                        version_start=version_start, version_end=version_start)
        tr.trace_id = t.new_trace_id()
        tr.t_dispatch = _time.monotonic()
        t.lineage("dispatch", tr.trace_id, root=True, qid=qid)
        return tr

    rb = ReplayBuffer(capacity=4, max_head_offpolicyness=1)
    with t.span("step", step=1):
        assert rb.put(traj("q-good"))
        assert rb.get_batch(1, timeout=0)[0].qid == "q-good"
        rb.set_version(3)
        assert not rb.put(traj("q-stale", version_start=0))
    t.flush()
    trace = t.merge_shards(str(tmp_path))
    assert t.validate_trace(trace) == []
    rows = {r["qid"]: r for r in report.lineage_rows(trace)}
    assert rows["q-good"]["complete"]
    assert {"dispatch", "admitted", "trained"} <= set(rows["q-good"]["stages"])
    assert rows["q-good"]["version_lag"] == 0
    assert not rows["q-stale"]["complete"]
    assert "rejected_stale" in rows["q-stale"]["stages"]
    assert "admitted" not in rows["q-stale"]["stages"]
    counters = {e["name"] for e in trace["traceEvents"] if e["ph"] == "C"}
    assert {"replay_buffer", "replay_staleness"} <= counters


# ---------------- the two packages' files, byte for byte ----------------


class _FakeClock:
    """monotonic_ns and time() advancing a fixed step a read."""

    def __init__(self):
        self.n = 0

    def monotonic_ns(self):
        self.n += 1
        return 10_000_000_000 + self.n * 1_234_567

    def time(self):
        self.n += 1
        return 1_700_000_000.0 + self.n * 0.001234


def _script(t, tmp_path, role):
    """One process's calls: spans (nested, decorated, explicit), an
    instant, counters, a lineage joined root to child, flight events and
    a dump, two flushes."""
    t.configure(role=role, rank=3, dir=str(tmp_path), enabled=True, force=True)
    with t.span("step", step=1):
        with t.span("mfc:actor:generate", cat="compute", n=4) as a:
            a["tokens"] = 96
            a["mfu"] = 0.125
        with t.span("xfer:data", cat="comms", src=0, dst=1) as a:
            a["bytes"] = 4096
        with t.span("load_data", cat="host"):
            pass
        t.instant("push", version=2)
        t.counter("kv_pool", live_tokens=12, allocated_tokens=64, utilization=0.1875)
        t.complete("request:q0", 10_000_000_000, cat=None, qid="q0", trace_id="tr-0001")
    t.flush()

    @t.trace("grade", cat="host")
    def grade():
        return True

    with t.span("step", step=2):
        with t.span("pipe:actor_gen", stage="actor_gen", chunk=0, n=2):
            grade()
        t.lineage("dispatch", "tr-0001", root=True, qid="q0", task="math")
        t.lineage("graded", "tr-0001", task="math", passed=True)
        t.lineage("admitted", "tr-0001", qid="q0", version_lag=1)
        t.lineage("trained", "tr-0001", qid="q0")
        t.flight_event("breaker", state="open")
    t.flush()
    return t.flight_dump("fault_kill", role=role, rank=3)


def _run_script(t, tmp_path, role, monkeypatch):
    clock = _FakeClock()
    monkeypatch.setattr(t, "time", clock)
    monkeypatch.setattr(t, "threading", types.SimpleNamespace(get_ident=lambda: 77))
    monkeypatch.setattr(os, "getpid", lambda: 4242)
    try:
        dump = _script(t, tmp_path, role)
    finally:
        t._reset_for_tests()
        monkeypatch.undo()
    return dump


def test_shards_and_dumps_equal_jax_byte_for_byte(tmp_path, monkeypatch):
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    _run_script(tracer, port_dir, "proc", monkeypatch)
    _run_script(jtracer, jax_dir, "proc", monkeypatch)
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir)) == [
        "flightrec_proc_3.json", "trace_proc_3.jsonl"]
    for name in os.listdir(port_dir):
        assert (port_dir / name).read_bytes() == (jax_dir / name).read_bytes(), name


def test_mixed_fleet_merges_and_reports_equal(tmp_path, monkeypatch):
    """A fleet mixing both packages: each package's merge and schema
    check read the other's shards, and the reports are equal."""
    _run_script(tracer, tmp_path, "port_proc", monkeypatch)
    _run_script(jtracer, tmp_path, "jax_proc", monkeypatch)
    got = tracer.merge_shards(str(tmp_path))
    want = jtracer.merge_shards(str(tmp_path))
    assert got == want
    assert tracer.validate_trace(want) == jtracer.validate_trace(got) == []
    assert len({e["pid"] for e in got["traceEvents"] if e["ph"] == "M"}) == 2
    assert trace_report.json_report(got) == jreport.json_report(want)
    assert trace_report.format_flight(str(tmp_path)) == jreport.format_flight(str(tmp_path))
    assert [d["role"] for d in tracer.read_flight_dumps(str(tmp_path))] == ["jax_proc",
                                                                         "port_proc"]


# ---------------- a traced generation server ----------------


def _tiny_engine(max_decode_batch=2):
    from areal_tpu.models import transformer as jtfm
    from areal_tpu.models.config import tiny_config as jtiny
    from areal_tpu_torch.engines.generator import GeneratorEngine
    from areal_tpu_torch.models.config import tiny_config
    from areal_tpu_torch.models.weights import params_from_numpy

    params = jtfm.init_params(jtiny(), jax.random.PRNGKey(11))
    return GeneratorEngine(
        tiny_config(), params_from_numpy(jax.tree.map(np.asarray, params), device="cpu"),
        "cpu", eos_token_id=7, max_decode_batch=max_decode_batch)


def _requests(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [{"qid": f"q{i}", "prompt_ids": [int(t) for t in rng.integers(8, 512, size=5)],
             "n": 1, "max_new_tokens": 4, "greedy": True} for i in range(n)]


def _serve(srv, reqs):
    outs = [None] * len(reqs)

    def call(i):
        outs[i] = srv._handle_generate(reqs[i])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return outs


def test_gen_server_traced_generate_emits_gauges(tmp_path):
    """A traced generate through the batching server: request spans,
    ``gen_batch`` and ``generate``, the serving plane's compute span and
    the gen_queue, kv_pool and gen_slots gauges, in one valid trace."""
    from areal_tpu_torch.system.gen_server import GenerationServer

    _configure(tmp_path, role="gen_server", rank=0)
    srv = GenerationServer(_tiny_engine(), max_wait_ms=20.0)
    try:
        assert all(o is not None and o["output_ids"] for o in _serve(srv, _requests()))
    finally:
        srv.close()
    trace = tracer.merge_shards(str(tmp_path))
    assert tracer.validate_trace(trace) == []
    evs = trace["traceEvents"]
    span_names = {e["name"] for e in evs if e["ph"] == "X"}
    assert {f"request:q{i}" for i in range(4)} <= span_names
    assert {"gen_batch", "generate"} <= span_names
    assert "serving_chunk" in {e["name"] for e in evs if e.get("cat") == "compute"}
    assert {"gen_queue", "kv_pool", "gen_slots"} <= {e["name"] for e in evs if e["ph"] == "C"}
    kv = next(e for e in evs if e["ph"] == "C" and e["name"] == "kv_pool")
    assert {"live_tokens", "allocated_tokens", "utilization"} <= set(kv["args"])
    assert "gen_server_0" in trace_report.format_report(trace)


def test_traced_server_request_lineage(tmp_path):
    """A request carrying a trace_id (the X-Areal-Trace header) gets its
    first_token and generated stamps and a request span joined to it."""
    from areal_tpu_torch.system.gen_server import GenerationServer

    _configure(tmp_path, role="gen_server", rank=0)
    srv = GenerationServer(_tiny_engine(), max_wait_ms=20.0)
    try:
        from areal_tpu_torch.api.model_api import (APIGenerateInput, GenerationHyperparameters,
                                                   LLMAPIClient)

        tid = tracer.new_trace_id()
        tracer.lineage("dispatch", tid, root=True, qid="q0")
        out = LLMAPIClient(srv.url).generate(APIGenerateInput(
            qid="q0", prompt_ids=[9, 10, 11], trace_id=tid,
            gconfig=GenerationHyperparameters(n=1, max_new_tokens=3, greedy=True)))
        assert len(out.output_ids[0]) == 3
    finally:
        srv.close()
    trace = tracer.merge_shards(str(tmp_path))
    assert tracer.validate_trace(trace) == []
    row = next(r for r in trace_report.lineage_rows(trace) if r["trace_id"] == tid)
    assert {"dispatch", "first_token", "generated"} <= set(row["stages"])
    req = next(e for e in trace["traceEvents"] if e.get("name") == "request:q0")
    assert req["args"]["trace_id"] == tid


# ---------------- tracing disabled ----------------


def _engine_counters(eng):
    return {k: getattr(eng, k) for k in ("steps_total", "lanes_dispatched", "lanes_live",
                                         "lanes_slack", "dead_live_lanes", "prefill_dispatches",
                                         "decode_compiles", "resume_replays", "static_chunks",
                                         "static_decode_steps")}


@pytest.mark.parametrize("path", ["serving", "static", "dense", "paged"])
def test_disabled_tracing_writes_nothing_and_keeps_the_counters(tmp_path, path):
    """The same burst traced and untraced: equal tokens and engine
    counters; untraced, no file."""
    from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
    from areal_tpu_torch.api.model_api import GenerationHyperparameters

    def run(traced):
        tracer._reset_for_tests()
        tracer.configure(role="gen", rank=0, dir=str(tmp_path / str(traced)), enabled=traced,
                         force=True)
        eng = _tiny_engine(max_decode_batch=4)
        if path == "dense":
            eng.kv_paged = False
        if path == "paged":
            eng.prefill_chunk_tokens = 0
        lens = [5, 9, 3]
        rng = np.random.default_rng(3)
        sample = SequenceSample(
            keys={"packed_prompts"}, ids=["a", "b", "c"],
            seqlens={"packed_prompts": [[n] for n in lens]},
            data={"packed_prompts": rng.integers(8, 512, size=sum(lens)).astype(np.int32)})
        g = GenerationHyperparameters(n=2, max_new_tokens=6, greedy=True)
        out = eng.generate(sample, MicroBatchSpec(), g, inflight=path != "static")
        tracer.flush()
        return out.data["packed_input_ids"].tolist(), _engine_counters(eng)

    toks_off, counters_off = run(False)
    toks_on, counters_on = run(True)
    assert toks_off == toks_on and counters_off == counters_on
    assert not (tmp_path / "False").exists()
    shard = tmp_path / "True" / "trace_gen_0.jsonl"
    names = {e["name"] for e in tracer.read_shard(str(shard))[1] if e.get("cat") == "compute"}
    want = {"serving": {"serving_chunk"}, "static": {"gen_chunk"},
            "dense": {"prefill", "decode_chunk"}, "paged": {"prefill", "decode_chunk"}}[path]
    assert names == want
