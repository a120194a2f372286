"""Remote generation over HTTP on the CPU: the port's
`RemoteGeneratorEngine` against the port's `GenerationServer`.

- its tokens equal an in-process engine's on the same weights, and
  those of the JAX package's `RemoteGeneratorEngine` against the same
  server (one wire format);
- a disk push (`set_params`: an HF checkpoint, then ``POST
  /update_weights``) raises the server's version and the server then
  generates what an in-process engine on the pushed weights generates;
- ``ckpt_root`` refuses a path, or a symlink, that resolves outside it;
- with ``inmem_sync`` a push pauses the server, parks a request in
  flight, swaps and resumes it under the new version;
- the worker builds the "remote_generator" backend, a trial through
  `build_ppo_math` and the quickstart CLI with ``gen_server_url`` run to
  their ends, and what is not ported (tcp:// and zmq:// URLs) is
  refused naming its item;
- ``push_mode="fabric"`` publishes each push once and sends it down a
  broadcast tree of the servers, and ``push_weights`` from either
  package's client lands one binary ``/param_push``."""

import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from areal_tpu.api.data_api import MicroBatchSpec as JSpec
from areal_tpu.api.data_api import SequenceSample as JSample
from areal_tpu.api.model_api import GenerationHyperparameters as JG
from areal_tpu.system.gen_server import RemoteGeneratorEngine as JRemote
from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model_api import (
    APIGenerateInput,
    GenerationHyperparameters,
    LLMAPIClient,
)
from areal_tpu_torch.engines.generator import GeneratorEngine
from areal_tpu_torch.models import transformer as tfm
from areal_tpu_torch.models.config import tiny_config
from areal_tpu_torch.models.hf import registry as hf
from areal_tpu_torch.system import paramstore
from areal_tpu_torch.system.gen_server import (
    GenerationServer,
    RemoteGeneratorEngine,
    make_gen_client,
)

torch.set_num_threads(2)

EOS = 7


def _params(seed):
    return tfm.init_params(tiny_config(), seed, device="cpu")


@pytest.fixture()
def root(tmp_path):
    return tmp_path


@pytest.fixture()
def server(root):
    eng = GeneratorEngine(tiny_config(), _params(11), "cpu", eos_token_id=EOS)
    srv = GenerationServer(eng, max_wait_ms=50.0, ckpt_root=str(root))
    yield srv
    srv.close()


def _sample(cls, lens=(6, 9, 13), seed=0):
    rng = np.random.default_rng(seed)
    return cls(
        keys={"packed_prompts"}, ids=[f"p{i}" for i in range(len(lens))],
        seqlens={"packed_prompts": [[n] for n in lens]},
        data={"packed_prompts": rng.integers(8, 512, sum(lens)).astype(np.int32)},
    )


def _local(params, sample, g):
    eng = GeneratorEngine(tiny_config(), params, "cpu", eos_token_id=EOS)
    return eng.generate(sample, MicroBatchSpec(), g, seed=0)


def _check_equal(got, want):
    np.testing.assert_array_equal(np.asarray(got.data["packed_input_ids"]),
                                  np.asarray(want.data["packed_input_ids"]))
    np.testing.assert_allclose(np.asarray(got.data["packed_logprobs"]),
                               np.asarray(want.data["packed_logprobs"]), atol=1e-5, rtol=0)
    assert got.seqlens == want.seqlens


@pytest.mark.parametrize("n", [1, 2])
def test_remote_tokens_equal_in_process(server, root, n):
    g = GenerationHyperparameters(n=n, max_new_tokens=6, greedy=True)
    remote = RemoteGeneratorEngine(tiny_config(), server.url, sync_dir=str(root / "sync"))
    got = remote.generate(_sample(SequenceSample), MicroBatchSpec(), g, seed=0)
    _check_equal(got, _local(_params(11), _sample(SequenceSample), g))
    # The JAX package's remote engine against the same server.
    jgot = JRemote(tiny_config(), server.url, sync_dir=str(root / "jsync")).generate(
        _sample(JSample), JSpec(), JG(n=n, max_new_tokens=6, greedy=True), seed=0)
    np.testing.assert_array_equal(np.asarray(jgot.data["packed_input_ids"]),
                                  np.asarray(got.data["packed_input_ids"]))


def test_two_servers_round_robin(root):
    engines = [GeneratorEngine(tiny_config(), _params(11), "cpu", eos_token_id=EOS)
               for _ in range(2)]
    servers = [GenerationServer(e, max_wait_ms=20.0, ckpt_root=str(root)) for e in engines]
    try:
        g = GenerationHyperparameters(n=1, max_new_tokens=5, greedy=True)
        remote = RemoteGeneratorEngine(tiny_config(), [s.url for s in servers],
                                       sync_dir=str(root / "sync"))
        sample = _sample(SequenceSample, lens=(5, 6, 7, 8))
        _check_equal(remote.generate(sample, MicroBatchSpec(), g), _local(_params(11), sample, g))
        assert all(e.static_chunks + e.steps_total > 0 for e in engines)
        remote.set_params(_params(12))  # a push reaches every server
        assert [s.version for s in servers] == [1, 1] and remote.pushes == 1
    finally:
        for s in servers:
            s.close()


def test_disk_push_raises_version(server, root):
    g = GenerationHyperparameters(n=2, max_new_tokens=6, greedy=True)
    remote = RemoteGeneratorEngine(tiny_config(), server.url, sync_dir=str(root / "sync"))
    before = remote.generate(_sample(SequenceSample), MicroBatchSpec(), g)
    new = _params(12)
    remote.set_params(new)
    assert server.version == 1 and remote.pushes == 1
    assert LLMAPIClient(server.url).health()["version"] == 1
    assert "config.json" in os.listdir(root / "sync")
    after = remote.generate(_sample(SequenceSample), MicroBatchSpec(), g)
    _check_equal(after, _local(new, _sample(SequenceSample), g))
    assert not np.array_equal(np.asarray(before.data["packed_input_ids"]),
                              np.asarray(after.data["packed_input_ids"]))
    with pytest.raises(NotImplementedError, match="generation-only"):
        remote.train_batch()
    with pytest.raises(NotImplementedError, match="live on the server"):
        remote.get_params()


def test_ckpt_root_refuses_paths_outside(server, root, tmp_path_factory):
    outside = tmp_path_factory.mktemp("outside")
    hf.save_hf_checkpoint(str(outside / "ck"), tiny_config(), _params(5))
    client = LLMAPIClient(server.url)
    with pytest.raises(RuntimeError, match="outside checkpoint root"):
        client.update_weights_from_disk(str(outside / "ck"))
    os.symlink(outside / "ck", root / "link")  # inside by name, outside once resolved
    with pytest.raises(RuntimeError, match="outside checkpoint root"):
        client.update_weights_from_disk(str(root / "link"))
    assert server.version == 0
    hf.save_hf_checkpoint(str(root / "ck"), tiny_config(), _params(5))
    assert client.update_weights_from_disk(str(root / "ck")) == 1


def test_inmem_sync_pauses_parks_and_resumes(root):
    """A disk push with inmem_sync while a request decodes on the serving
    plane: the client pauses the server, the request parks at a chunk
    boundary, /update_weights swaps under the engine lock, the resume
    replays the request's chunk and it finishes under version 1."""
    eng = GeneratorEngine(tiny_config(), _params(11), "cpu", eos_token_id=EOS,
                          max_decode_batch=2)
    eng.static_path_max_new = 0  # every call takes the serving plane, which parks
    srv = GenerationServer(eng, max_wait_ms=20.0, ckpt_root=str(root))
    try:
        remote = RemoteGeneratorEngine(tiny_config(), srv.url, sync_dir=str(root / "sync"),
                                       inmem_sync=True)
        calls = []
        client = remote.clients[0]
        for name in ("pause", "resume", "update_weights_from_disk"):
            real = getattr(client, name)
            setattr(client, name, lambda *a, _n=name, _r=real: (calls.append(_n), _r(*a))[1])
        g = GenerationHyperparameters(n=1, max_new_tokens=96, greedy=True)
        inps = [APIGenerateInput(qid=f"q{i}", prompt_ids=[10 + i, 11, 12, 13], gconfig=g)
                for i in range(4)]
        box = {}
        th = threading.Thread(target=lambda: box.update(outs=LLMAPIClient(srv.url)
                                                        .generate_batch(inps)))
        th.start()
        probe = LLMAPIClient(srv.url)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and probe.health()["live_slots"] == 0:
            time.sleep(0.002)
        assert probe.health()["live_slots"] > 0, "decode never started"
        pusher = threading.Thread(target=remote.set_params, args=(_params(99),))
        pusher.start()
        pusher.join(timeout=120)
        th.join(timeout=120)
        assert not pusher.is_alive() and not th.is_alive()
        assert calls == ["pause", "update_weights_from_disk", "resume"]
        assert srv.version == 1 and not probe.health()["paused"]
        spanned = [o for o in box["outs"] if o.version_start == 0 and o.version == 1]
        assert spanned and eng.resume_replays >= 1
    finally:
        srv.close()


def test_refusals_name_their_items():
    with pytest.raises(NotImplementedError, match="item 7.8"):
        make_gen_client("tcp://127.0.0.1:5555")
    with pytest.raises(NotImplementedError, match="item 7.8"):
        RemoteGeneratorEngine(tiny_config(), "zmq://127.0.0.1:5555")
    with pytest.raises(ValueError, match="push_mode"):
        RemoteGeneratorEngine(tiny_config(), "http://127.0.0.1:1", push_mode="carrier")
    with pytest.raises(NotImplementedError, match="item 7.8"):
        paramstore.push_payload("zmq://127.0.0.1:5555", {}, b"")


@pytest.mark.parametrize("fanout", [1, 2])
def test_fabric_push_reaches_every_server(root, fanout):
    """push_mode="fabric": each set_params publishes once and pushes down
    the tree (a relay chain at fanout 1); every server serves the pushed
    version and generates what an in-process engine on those weights
    generates; no checkpoint is written."""
    servers = [GenerationServer(GeneratorEngine(tiny_config(), _params(11), "cpu",
                                                eos_token_id=EOS), max_wait_ms=20.0)
               for _ in range(3)]
    try:
        remote = RemoteGeneratorEngine(tiny_config(), [s.url for s in servers],
                                       sync_dir=str(root / "sync"), push_mode="fabric",
                                       push_fanout=fanout)
        g = GenerationHyperparameters(n=1, max_new_tokens=5, greedy=True)
        sample = _sample(SequenceSample, lens=(5, 6, 7))
        for v, seed in ((1, 12), (2, 13)):
            new = _params(seed)
            remote.set_params(new)
            assert [s.version for s in servers] == [v] * 3 and remote.pushes == v
            _check_equal(remote.generate(sample, MicroBatchSpec(), g), _local(new, sample, g))
        fabric = remote._fabric
        assert fabric.store.head == 2 and fabric.fanout == fanout
        assert fabric.store.pins(2) == sorted(f"server:{s.url}" for s in servers)
        assert not os.path.exists(root / "sync" / "config.json")
    finally:
        for s in servers:
            s.close()


@pytest.mark.parametrize("client_pkg", ["port", "jax"])
def test_push_weights_round_trip(server, client_pkg):
    """One binary /param_push, sent by either package's client, swaps the
    server's weights at the pushed version and acks its sid."""
    from areal_tpu.api.model_api import LLMAPIClient as JClient
    from areal_tpu_torch.base import integrity

    new = _params(14)
    manifest, payload = paramstore.serialize_params(new)
    meta = {"cmd": "param_push", "version": 5, "manifest": manifest,
            "checksum": integrity.params_checksum(new).tolist(),
            "subtree": {"sid": "only", "url": server.url, "children": []}}
    client = LLMAPIClient(server.url) if client_pkg == "port" else JClient(server.url)
    ack = client.push_weights(meta, payload if client_pkg == "port" else bytes(payload))
    assert ack == {"version": 5, "applied": ["only"], "failed": []} and server.version == 5
    assert all(torch.equal(a, b) for a, b in zip(integrity._leaves(server.engine.params),
                                                 integrity._leaves(new)))


def test_bounded_agenerate(server):
    """agenerate runs generate in a thread, at most max_inflight at once a
    loop."""
    import asyncio

    client = LLMAPIClient(server.url, max_inflight=2)
    active, peak = [0], [0]
    real = client.generate

    def generate(inp):
        active[0] += 1
        peak[0] = max(peak[0], active[0])
        try:
            return real(inp)
        finally:
            active[0] -= 1

    client.generate = generate
    g = GenerationHyperparameters(n=1, max_new_tokens=3, greedy=True)

    async def go():
        return await asyncio.gather(*[
            client.agenerate(APIGenerateInput(qid=f"a{i}", prompt_ids=[9, 10 + i], gconfig=g))
            for i in range(6)])

    outs = asyncio.run(go())
    assert [o.qid for o in outs] == [f"a{i}" for i in range(6)] and peak[0] <= 2


# ---------------- through the system's entry points ----------------

def _ckpt_server(root):
    ck = root / "ckpt"
    hf.save_hf_checkpoint(str(ck), tiny_config(), _params(21))
    cfg, params = hf.load_hf_checkpoint(str(ck), device="cpu")
    from areal_tpu_torch.data.tokenizer import CharTokenizer

    eng = GeneratorEngine(cfg, params, "cpu", eos_token_id=CharTokenizer(512).eos_token_id)
    return str(ck), GenerationServer(eng, max_wait_ms=20.0, ckpt_root=str(root))


def test_trial_generates_on_the_server(root, monkeypatch):
    """build_ppo_math + run_experiment with gen_server_url, inmem sync
    and cap 1: the worker's generator is a RemoteGeneratorEngine, each
    step's sync is a disk push (server version = pushes), and the trial
    keeps its staleness bound."""
    import tempfile

    from areal_tpu_torch.api.config import ModelAbstraction
    from areal_tpu_torch.api.data_api import DatasetAbstraction
    from areal_tpu_torch.api.model_api import OptimizerConfig
    from areal_tpu_torch.data.tokenizer import CharTokenizer
    from areal_tpu_torch.experiments import common as exps
    from tests import fixtures

    monkeypatch.setattr(tempfile, "tempdir", str(root))  # the push's sync dir
    ckpt, srv = _ckpt_server(root)
    try:
        rows = fixtures.build_math_rows(12, seed=2)
        cfg = exps.PPOMathConfig(
            actor=ModelAbstraction("hf", {"path": ckpt}),
            dataset=DatasetAbstraction(
                "math_code_prompt", {"dataset_builder": lambda: rows, "max_length": 64}),
            reward_interface_args={"id2info": {r["query_id"]: r for r in rows}},
            gconfig=GenerationHyperparameters(n=2, max_new_tokens=8),
            ppo_kwargs={"n_minibatches": 1},
            optimizer=OptimizerConfig(lr=1e-3, warmup_steps_proportion=0.0),
            batch_size=4, fileroot=str(root / "trial"),
            gen_server_url=srv.url, inmem_weight_sync=True, max_head_offpolicyness=1,
        )
        tok = CharTokenizer(512)
        master, stats = exps.run_experiment(exps.build_ppo_math(cfg, tok), tokenizer=tok,
                                            device="cpu")
        remote = master.pool.workers[0].models["actor_gen@0"].engine
        assert isinstance(remote, RemoteGeneratorEngine) and remote.inmem_sync
        assert len(stats) == 3 and remote.pushes == 3 and srv.version == 3
        assert all(s["replay/staleness"] <= 1 and s["replay/rejected"] == 0 for s in stats)
        assert all(np.isfinite(s["actor_train/behav_imp_weight"]) for s in stats)
        assert os.path.dirname(remote.sync_dir) == str(root)
    finally:
        srv.close()


def test_quickstart_with_gen_server_url(root, monkeypatch):
    import json
    import tempfile

    from areal_tpu_torch.apps import quickstart
    from tests import fixtures

    monkeypatch.setattr(tempfile, "tempdir", str(root))
    ckpt, srv = _ckpt_server(root)
    try:
        data = root / "math.jsonl"
        with open(data, "w") as f:
            for row in fixtures.build_math_rows(8, seed=4):
                f.write(json.dumps(row) + "\n")
        argv = ["ppo-math", "--model.path", ckpt, "--dataset.path", str(data),
                "--tokenizer-path", "char:512", "--batch-size", "4", "--group-size", "2",
                "--max-new-tokens", "8", "--fileroot", str(root / "q"),
                "--gen-server-url", srv.url, "--inmem-weight-sync"]
        stats = quickstart.main(argv, device="cpu")
        assert len(stats) == 2 and np.isfinite(stats[-1]["actor_train/actor_loss"])
        assert srv.version == 2
        with pytest.raises(SystemExit, match="item 7.8"):
            quickstart.main(argv[:-3] + ["--gen-server-url", "tcp://127.0.0.1:1"],
                            device="cpu")
    finally:
        srv.close()
