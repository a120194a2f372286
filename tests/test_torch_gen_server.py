"""The port's GenerationServer speaks the JAX server's wire format: the
JAX package's `LLMAPIClient` talks to it unchanged, and its greedy output
equals the JAX engine's (twin of tests/test_gen_server.py's round trip)."""

import json
import threading
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
    g = GenerationHyperparameters(n=1, max_new_tokens=4, spec_decode_k=2)
    with pytest.raises(RuntimeError, match="not yet ported"):
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
