"""The port's GenerationServer speaks the JAX server's wire format: the
JAX package's `LLMAPIClient` talks to it unchanged, and its greedy output
equals the JAX engine's (twin of tests/test_gen_server.py's round trip)."""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from areal_tpu.api.data_api import MicroBatchSpec as JSpec
from areal_tpu.api.data_api import SequenceSample as JSample
from areal_tpu.api.model_api import APIGenerateInput, GenerationHyperparameters, LLMAPIClient
from areal_tpu.base.topology import ParallelConfig, make_mesh
from areal_tpu.engines.generator import GeneratorEngine as JEngine
from areal_tpu.models import transformer as jtfm
from areal_tpu.models.config import tiny_config as jtiny
from areal_tpu_torch.engines.generator import GeneratorEngine
from areal_tpu_torch.models.config import tiny_config
from areal_tpu_torch.models.weights import params_from_numpy
from areal_tpu_torch.system.gen_server import GenerationServer

torch.set_num_threads(2)

EOS = 7


@pytest.fixture(scope="module")
def params():
    return jtfm.init_params(jtiny(), jax.random.PRNGKey(11))


@pytest.fixture(scope="module")
def engine(params):
    return GeneratorEngine(
        tiny_config(), params_from_numpy(jax.tree.map(np.asarray, params), device="cpu"),
        "cpu", eos_token_id=EOS,
    )


@pytest.fixture()
def server(engine):
    srv = GenerationServer(engine, max_wait_ms=50.0)
    yield srv
    srv.close()


def _prompt_sample(rng, lens):
    data = np.concatenate(
        [rng.integers(8, 512, size=l) for l in lens]
    ).astype(np.int32)
    return JSample(
        keys={"packed_prompts"}, ids=[f"p{i}" for i in range(len(lens))],
        seqlens={"packed_prompts": [[l] for l in lens]},
        data={"packed_prompts": data},
    )


@pytest.mark.parametrize("n", [1, 2])
def test_llm_api_client_roundtrip_matches_jax_engine(server, params, n):
    rng = np.random.default_rng(0)
    sample = _prompt_sample(rng, (6, 9, 13))
    g = GenerationHyperparameters(n=n, max_new_tokens=6, greedy=True)
    client = LLMAPIClient(server.url)
    assert client.health()["status"] == "ok"
    prompts = np.asarray(sample.data["packed_prompts"])
    bounds = sample.cu_seqlens("packed_prompts")
    outs = client.generate_batch([
        APIGenerateInput(
            qid=sample.ids[i],
            prompt_ids=[int(t) for t in prompts[bounds[i]:bounds[i + 1]]],
            gconfig=g,
        )
        for i in range(sample.bs)
    ])
    mesh = make_mesh(ParallelConfig.from_str("d1"), jax.devices()[:1])
    ref = JEngine(jtiny(), params, mesh, eos_token_id=EOS).generate(sample, JSpec(), g)
    per_id = {s.ids[0]: s for s in ref.unpack()}
    for o in outs:
        want = np.asarray(per_id[o.qid].data["packed_input_ids"])
        lens = per_id[o.qid].seqlens["packed_input_ids"][0]
        assert len(o.output_ids) == n
        off = 0
        for r in range(n):
            got = np.asarray(o.prompt_ids + o.output_ids[r], np.int32)
            np.testing.assert_array_equal(got, want[off:off + lens[r]])
            assert len(o.output_logprobs[r]) == len(o.output_ids[r])
            off += lens[r]


def test_health_reports_load(server):
    h = LLMAPIClient(server.url).health()
    assert h["status"] == "ok" and h["paused"] is False
    assert h["capacity"] == 64 and h["queue_depth"] == 0


def test_errors_reach_the_client(server):
    client = LLMAPIClient(server.url)
    # A malformed request the engine refuses: zero responses per prompt.
    g = GenerationHyperparameters(n=0, max_new_tokens=4)
    with pytest.raises(RuntimeError, match="gconfig.n must be >= 1"):
        client.generate(APIGenerateInput(qid="q", prompt_ids=[9, 10, 11], gconfig=g))
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(server.url + "/nope")
    assert e.value.code == 404
    # The server survives a failed batch.
    ok = client.generate(APIGenerateInput(
        qid="q2", prompt_ids=[9, 10, 11],
        gconfig=GenerationHyperparameters(n=1, max_new_tokens=3, greedy=True),
    ))
    assert len(ok.output_ids[0]) == 3


def test_spec_request_succeeds(server):
    """A request with spec_decode_k > 0 is served, and its greedy tokens
    are the plain request's."""
    client = LLMAPIClient(server.url)
    outs = [
        client.generate(APIGenerateInput(
            qid=f"q{k}", prompt_ids=[9, 10, 11, 9, 10], gconfig=GenerationHyperparameters(
                n=2, max_new_tokens=6, greedy=True, spec_decode_k=k, spec_ngram=2),
        ))
        for k in (0, 3)
    ]
    assert outs[1].output_ids == outs[0].output_ids
    assert all(len(ids) == 6 for ids in outs[1].output_ids)


def test_spec_ngram_reaches_the_engine(server):
    """A request's spec_decode_k and spec_ngram reach the engine's
    GenerationHyperparameters (the JAX server reads both,
    areal_tpu/system/gen_server.py:820-821)."""
    seen = []
    real = server.engine.generate

    def record(sample, mb_spec, g, *a, **k):
        seen.append(g)
        return real(sample, mb_spec, g, *a, **k)

    server.engine.generate = record
    try:
        LLMAPIClient(server.url).generate(APIGenerateInput(
            qid="q", prompt_ids=[9, 10, 11], gconfig=GenerationHyperparameters(
                n=1, max_new_tokens=3, greedy=True, spec_decode_k=2, spec_ngram=5),
        ))
    finally:
        del server.engine.generate
    assert [(g.spec_decode_k, g.spec_ngram) for g in seen] == [(2, 5)]


def test_token_auth(engine):
    srv = GenerationServer(engine, token="s3cret")
    try:
        req = urllib.request.Request(
            srv.url + "/generate", data=json.dumps({"qid": "q"}).encode(),
        )
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req)
        assert e.value.code == 403
        out = LLMAPIClient(srv.url, token="s3cret").generate(APIGenerateInput(
            qid="q", prompt_ids=[9, 10],
            gconfig=GenerationHyperparameters(n=1, max_new_tokens=2, greedy=True),
        ))
        assert len(out.output_ids[0]) == 2
    finally:
        srv.close()
    with pytest.raises(ValueError, match="token"):
        GenerationServer(engine, host="0.0.0.0")


def test_concurrent_burst_lands_in_one_engine_call(params):
    """32 clients posting at once are merged into ONE generate call: the
    listen backlog must hold the whole burst inside the batcher's
    linger window."""
    eng = GeneratorEngine(
        tiny_config(), params_from_numpy(jax.tree.map(np.asarray, params), device="cpu"),
        "cpu", eos_token_id=EOS,
    )
    sizes = []
    real = eng.generate

    def counting(sample, *a, **k):
        sizes.append(sample.bs)
        return real(sample, *a, **k)

    eng.generate = counting
    srv = GenerationServer(eng, max_wait_ms=600.0)
    n = 32
    go = threading.Barrier(n)
    errors = []

    def client(i):
        go.wait(timeout=30)
        try:
            LLMAPIClient(srv.url).generate(APIGenerateInput(
                qid=f"q{i}", prompt_ids=[9 + i, 10, 11],
                gconfig=GenerationHyperparameters(n=1, max_new_tokens=2, greedy=True),
            ))
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        srv.close()
    assert not errors and not any(th.is_alive() for th in threads)
    assert sizes == [n]


def test_wire_dataclasses_match_jax():
    """The request/response dataclasses carry the JAX package's fields
    and defaults, so both sides of the wire agree."""
    import dataclasses

    from areal_tpu.api import model_api as jm
    from areal_tpu_torch.api import model_api as tm

    for name in ("GenerationHyperparameters", "APIGenerateInput", "APIGenerateOutput"):
        jf = [(f.name, f.default) for f in dataclasses.fields(getattr(jm, name))]
        tf = [(f.name, f.default) for f in dataclasses.fields(getattr(tm, name))]
        assert jf == tf, name
    g = tm.GenerationHyperparameters(stop=[[1, 2], [3]])
    assert g.stop == ((1, 2), (3,)) and hash(g.stop)
    inp = tm.APIGenerateInput(qid="q", prompt_ids=[1, 2, 3], gconfig=g)
    out = tm.APIGenerateOutput.from_input(inp)
    assert out.prompt_len == 3 and out.output_lens == []


# --------------------------------------------------------------------------
# Pause / resume and the in-memory weight push (twins of the
# TestAsyncServing cases in tests/test_gen_server.py)
# --------------------------------------------------------------------------


def _torch_params(key):
    return params_from_numpy(
        jax.tree.map(np.asarray, jtfm.init_params(jtiny(), jax.random.PRNGKey(key))),
        device="cpu",
    )


def test_pause_parks_generation_until_resume(server):
    client = LLMAPIClient(server.url)
    client.pause()
    assert client.health()["paused"] is True
    g = GenerationHyperparameters(n=1, max_new_tokens=4, greedy=True)
    box = {}

    def run():
        box["out"] = client.generate(APIGenerateInput(qid="p", prompt_ids=[10, 11, 12], gconfig=g))

    th = threading.Thread(target=run)
    th.start()
    th.join(timeout=0.3)  # parked: no reply while paused
    assert th.is_alive() and "out" not in box
    client.resume()
    th.join(timeout=60)
    assert not th.is_alive()
    assert len(box["out"].output_ids[0]) == 4
    assert client.health()["paused"] is False


def test_update_weights_inmem_bumps_version(params):
    eng = GeneratorEngine(
        tiny_config(), params_from_numpy(jax.tree.map(np.asarray, params), device="cpu"),
        "cpu", eos_token_id=EOS,
    )
    srv = GenerationServer(eng, max_wait_ms=2.0)
    try:
        client = LLMAPIClient(srv.url)
        g = GenerationHyperparameters(n=1, max_new_tokens=8, greedy=True)
        inp = APIGenerateInput(qid="q", prompt_ids=list(range(10, 20)), gconfig=g)
        before = client.generate(inp)
        assert before.version == before.version_start == 0
        assert srv.update_weights_inmem(_torch_params(99)) == srv.version == 1
        after = client.generate(inp)
        assert after.version == after.version_start == 1
        assert before.output_ids != after.output_ids
        assert client.health()["paused"] is False
        # An absolute version at or behind the current one is a no-op.
        assert srv.update_weights_inmem(_torch_params(98), version=1) == 1
        assert srv.inmem_updates == 1
        assert srv.update_weights_inmem(_torch_params(98), version=5) == 5
    finally:
        srv.close()


def test_inmem_push_interrupts_and_resumes_inflight():
    """A weight push lands mid-decode: the running call parks at a chunk
    boundary, the weights are swapped, and the requests finish on their
    existing KV pages under the new version, keeping their start
    version."""
    eng = GeneratorEngine(tiny_config(), _torch_params(11), "cpu", eos_token_id=EOS,
                          max_decode_batch=2)
    # The four requests may reach the engine in several calls, and a call
    # of up to max_decode_batch requests would take the static path,
    # which cannot park: by the JAX engine's rule (more new tokens than
    # static_path_max_new go inflight) every call takes the serving plane.
    eng.static_path_max_new = 0
    srv = GenerationServer(eng, max_wait_ms=20.0)
    try:
        client = LLMAPIClient(srv.url)
        g = GenerationHyperparameters(n=1, max_new_tokens=96, greedy=True)
        inps = [
            APIGenerateInput(qid=f"q{i}", prompt_ids=[10 + i, 11, 12, 13], gconfig=g)
            for i in range(4)
        ]
        box = {}

        def run():
            box["outs"] = client.generate_batch(inps)

        th = threading.Thread(target=run)
        th.start()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and client.health()["live_slots"] == 0:
            time.sleep(0.002)
        assert client.health()["live_slots"] > 0, "decode never started"
        # The push waits for the running call to park and free the engine
        # lock: run it in a thread too, so a lock that is never released
        # fails the test instead of hanging it.
        pushed = {}
        pusher = threading.Thread(
            target=lambda: pushed.update(v=srv.update_weights_inmem(_torch_params(99)))
        )
        pusher.start()
        pusher.join(timeout=120)
        assert not pusher.is_alive() and pushed["v"] == 1
        th.join(timeout=120)
        assert not th.is_alive()
        outs = box["outs"]
        assert len(outs) == 4
        spanned = [o for o in outs if o.version_start == 0 and o.version == 1]
        assert spanned, [(o.qid, o.version_start, o.version) for o in outs]
        assert eng.resume_replays >= 1
        for o in outs:
            assert len(o.output_ids[0]) == len(o.output_logprobs[0]) >= 1
    finally:
        srv.close()


def test_push_during_a_static_call_drains():
    """Twin of the JAX server's drain rule: a burst that fits one static
    chunk runs as one program, which cannot park.  A push landing while
    it runs waits for it: the call finishes whole under the old weights
    (its greedy tokens equal an undisturbed old-weights run's, every
    reply carries version_start == version == 0), then the swap lands,
    no interrupt is left set, and the next call serves version 1."""
    eng = GeneratorEngine(tiny_config(), _torch_params(11), "cpu", eos_token_id=EOS)
    # One request of n=3, so the burst is one engine call however busy
    # the host is.
    g = GenerationHyperparameters(n=3, max_new_tokens=12, greedy=True)
    inp = APIGenerateInput(qid="q", prompt_ids=[10, 11, 12, 13, 14, 15], gconfig=g)
    ref_eng = GeneratorEngine(tiny_config(), _torch_params(11), "cpu", eos_token_id=EOS)
    paths, started = [], threading.Event()
    real_static, real_serving = eng._generate_chunk, eng._generate_inflight_serving

    def held_static(*a, **k):
        # Hold the first program until the push has asked the engine to
        # park.
        paths.append("static")
        if not started.is_set():
            started.set()
            deadline = time.monotonic() + 60
            while not eng.interrupt_requested and time.monotonic() < deadline:
                time.sleep(0.005)
            assert eng.interrupt_requested, "the push never asked to park"
        return real_static(*a, **k)

    def serving(*a, **k):
        paths.append("inflight")
        return real_serving(*a, **k)

    eng._generate_chunk, eng._generate_inflight_serving = held_static, serving
    srv = GenerationServer(eng, max_wait_ms=20.0)
    ref_srv = GenerationServer(ref_eng, max_wait_ms=20.0)
    try:
        client = LLMAPIClient(srv.url)
        box = {}
        th = threading.Thread(target=lambda: box.update(out=client.generate(inp)))
        th.start()
        assert started.wait(timeout=60), "the static call never started"
        pushed = {}
        pusher = threading.Thread(
            target=lambda: pushed.update(v=srv.update_weights_inmem(_torch_params(99)))
        )
        pusher.start()
        pusher.join(timeout=120)
        th.join(timeout=120)
        assert not pusher.is_alive() and not th.is_alive()
        assert pushed["v"] == srv.version == 1
        assert paths == ["static"]
        out = box["out"]
        assert out.version_start == out.version == 0
        assert len(out.output_ids) == 3
        assert out.output_ids == LLMAPIClient(ref_srv.url).generate(inp).output_ids
        assert eng.resume_replays == 0 and not eng.interrupted
        assert not eng.interrupt_requested
        assert client.health()["paused"] is False
        after = client.generate(inp)
        assert after.version_start == after.version == 1
        assert paths == ["static", "static"]
        assert after.output_ids != out.output_ids
    finally:
        srv.close()
        ref_srv.close()


def test_params_checksum_matches_jax(params):
    """The port's checksum of its tree equals the JAX package's of the
    same numpy weights, leaf for leaf, and verifies against it."""
    from areal_tpu.base import integrity as jint
    from areal_tpu_torch.base import integrity as tint

    host = jax.tree.map(np.asarray, params)
    want = jint.params_checksum(host)
    got = tint.params_checksum(params_from_numpy(host, device="cpu"))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert tint.checksum_matches(got, jint.params_checksum(params))
    tint.verify_checksum(params_from_numpy(host, device="cpu"), want)
    assert np.array_equal(tint.params_checksum(host), want)


def test_corrupted_push_is_refused_and_old_weights_serve(params):
    from areal_tpu.base import integrity as jint
    from areal_tpu_torch.base import integrity as tint

    eng = GeneratorEngine(tiny_config(), _torch_params(11), "cpu", eos_token_id=EOS)
    srv = GenerationServer(eng, max_wait_ms=2.0)
    try:
        client = LLMAPIClient(srv.url)
        inp = APIGenerateInput(
            qid="q", prompt_ids=list(range(10, 20)),
            gconfig=GenerationHyperparameters(n=1, max_new_tokens=6, greedy=True),
        )
        new = _torch_params(99)
        good = jint.params_checksum(jax.tree.map(np.asarray, jtfm.init_params(jtiny(), jax.random.PRNGKey(99))))
        assert srv.update_weights_inmem(new, checksum=good) == 1
        served = client.generate(inp)
        bad = _torch_params(77)
        bad["blocks"]["wq"] = bad["blocks"]["wq"] * 1.5
        with pytest.raises(tint.WeightChecksumError):
            srv.update_weights_inmem(bad, checksum=tint.params_checksum(_torch_params(77)))
        assert srv.version == 1 and client.health()["paused"] is False
        again = client.generate(inp)
        assert again.version == again.version_start == 1
        assert again.output_ids == served.output_ids
    finally:
        srv.close()


# --------------------------------------------------------------------------
# Agent episodes over HTTP (twins of TestEpisodeServing in
# tests/test_gen_server.py): the port's client and the JAX package's both
# drive POST /episode on the port's server.
# --------------------------------------------------------------------------

EP_EOS = jtiny().vocab_size + 7  # outside the vocab: turns end on stops


def _episode_server(**ekw):
    eng = GeneratorEngine(tiny_config(), _torch_params(13), "cpu", eos_token_id=EP_EOS,
                          kv_page_size=8, prefill_chunk_tokens=4, max_decode_batch=2, **ekw)
    return eng, GenerationServer(eng, max_wait_ms=2.0)


def _clients(url):
    from areal_tpu_torch.api import model_api as tapi

    return {"port": (tapi.LLMAPIClient(url), tapi.GenerationHyperparameters,
                     tapi.SlotGoneError),
            "jax": (LLMAPIClient(url), GenerationHyperparameters,
                    __import__("areal_tpu.api.model_api", fromlist=["x"]).SlotGoneError)}


@pytest.fixture(scope="module")
def ep_env():
    eng, srv = _episode_server()
    rng = np.random.default_rng(7)
    prompt = [int(x) for x in rng.integers(8, jtiny().vocab_size, size=10)]
    probe = LLMAPIClient(srv.url).generate(APIGenerateInput(
        qid="probe", prompt_ids=prompt,
        gconfig=GenerationHyperparameters(n=1, max_new_tokens=8, greedy=True),
    ))
    yield srv, prompt, [int(t) for t in probe.output_ids[0]]
    srv.close()


@pytest.mark.parametrize("who", ["port", "jax"])
def test_http_episode_lifecycle(ep_env, who):
    """start -> extend -> release through either package's client: turn 0
    ends on the probe's stop pair (kept in the turn), turn 1 prefills
    only the observation, and the transcript adds up."""
    srv, prompt, toks = ep_env
    client, G, _ = _clients(srv.url)[who]
    g = G(n=1, max_new_tokens=8, greedy=True, stop=(tuple(toks[2:4]),))
    t1 = client.episode_start(f"ep-{who}", prompt, g, token_budget=64)
    assert t1["stop_reason"] == "stop"
    assert t1["tokens"][-2:] == toks[2:4] and t1["tokens"] == toks[: len(t1["tokens"])]
    assert t1["version"] == t1["version_start"] == 0
    obs = [int(x) + 1 for x in prompt[:3]]
    t2 = client.episode_extend(f"ep-{who}", obs)
    assert t2["prefill_tokens"] == len(obs)
    assert t2["transcript_len"] == len(prompt) + len(t1["tokens"]) + len(obs) + len(t2["tokens"])
    assert len(t2["logprobs"]) == len(t2["tokens"])
    assert client.episode_release(f"ep-{who}")["released"] is True
    assert client.episode_release(f"ep-{who}")["released"] is False


@pytest.mark.parametrize("who", ["port", "jax"])
def test_http_continuation_on_reclaimed_slot_is_typed(ep_env, who):
    """A continuation after release gets HTTP 409 with the slot_gone body,
    which either client raises as its SlotGoneError; the server's
    slot-lost counter goes up by one."""
    from areal_tpu_torch.base import metrics

    srv, prompt, toks = ep_env
    client, G, Gone = _clients(srv.url)[who]
    g = G(n=1, max_new_tokens=8, greedy=True, stop=(tuple(toks[2:4]),))
    client.episode_start(f"gone-{who}", prompt, g, token_budget=64)
    client.episode_release(f"gone-{who}")
    counter = metrics.default_registry().get("areal_gen_episode_slot_lost_total")
    lost0 = counter.get()
    with pytest.raises(Gone) as ei:
        client.episode_extend(f"gone-{who}", [9, 10])
    assert ei.value.episode_id == f"gone-{who}" and ei.value.reason == "slot reclaimed"
    assert counter.get() == lost0 + 1
    req = urllib.request.Request(
        srv.url + "/episode", headers={"Content-Type": "application/json"},
        data=json.dumps({"op": "extend", "episode_id": "nobody", "obs_ids": [1]}).encode(),
    )
    with pytest.raises(urllib.error.HTTPError) as he:
        urllib.request.urlopen(req, timeout=30)
    assert he.value.code == 409
    assert json.loads(he.value.read())["error_type"] == "slot_gone"


def test_push_during_an_episode_turn_and_a_generate_burst():
    """A push lands while an episode turn runs and a /generate burst waits
    for the engine: the turn parks mid-turn, the burst's call parks, the
    weights swap, the turn resumes on its pages (one K3 replay) and ends
    under version 1, the burst finishes, and no interrupt or parked
    session is left behind."""
    eng, srv = _episode_server()
    eng.static_path_max_new = 0  # the burst takes the serving plane, which parks
    in_turn = threading.Event()
    real_chunk_fn = eng._episode_chunk_fn

    def chunk_fn(st, g):
        fn = real_chunk_fn(st, g)

        def run(*a, **k):
            out = fn(*a, **k)
            if not in_turn.is_set():  # hold the turn after its first chunk
                in_turn.set()
                deadline = time.monotonic() + 60
                while not eng.interrupt_requested and time.monotonic() < deadline:
                    time.sleep(0.005)
            return out

        return run

    eng._episode_chunk_fn = chunk_fn
    try:
        client = LLMAPIClient(srv.url)
        g = GenerationHyperparameters(n=1, max_new_tokens=48, greedy=True)
        box = {}
        ep = threading.Thread(target=lambda: box.update(turn=client.episode_start(
            "ep-push", list(range(20, 41)), g, token_budget=128)))
        ep.start()
        assert in_turn.wait(timeout=60), "the episode turn never ran a chunk"
        inps = [APIGenerateInput(qid=f"q{i}", prompt_ids=[10 + i, 11, 12, 13], gconfig=g)
                for i in range(3)]
        burst = threading.Thread(target=lambda: box.update(outs=client.generate_batch(inps)))
        burst.start()
        time.sleep(0.3)  # the burst's call is queued behind the engine lock
        pushed = {}
        pusher = threading.Thread(
            target=lambda: pushed.update(v=srv.update_weights_inmem(_torch_params(99))))
        pusher.start()
        for th in (pusher, ep, burst):
            th.join(timeout=120)
        assert not any(th.is_alive() for th in (pusher, ep, burst))
        assert pushed["v"] == srv.version == 1
        turn = box["turn"]
        assert (turn["version_start"], turn["version"]) == (0, 1)
        assert turn["stop_reason"] == "length" and len(turn["tokens"]) == 48
        assert eng.resume_replays == 1  # the turn's replay; the burst had no live row
        for o in box["outs"]:
            assert o.version == 1 and len(o.output_ids[0]) == 48
        assert not eng.interrupted and not eng.interrupt_requested
        assert eng.episode_stats()["parked_mid_turn"] == 0
        assert client.health()["paused"] is False
    finally:
        srv.close()
