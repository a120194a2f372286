"""The port's chaos seams against the JAX package's, on the CPU: the
injector's `poison` verdicts, `integrity.corrupt_params`, the train
engine's NaN-poisoned gradients (`train_batch` and `train_stream_end`),
the generation server's fault points (``generate``, ``health``,
``param_push``) and its corrupted in-memory push, and the worker's
poisoned `param_send`.  Inputs come from a seed with numpy."""

import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from areal_tpu.api.data_api import MicroBatchSpec as JMicroBatchSpec
from areal_tpu.base import faults as jfaults
from areal_tpu.base import integrity as jint
from areal_tpu.base.topology import ParallelConfig, make_mesh
from areal_tpu.engines.generator import GeneratorEngine as JEngine
from areal_tpu.models import transformer as jtfm
from areal_tpu.models.config import tiny_config as jtiny
from areal_tpu.ops import functional as jF
from areal_tpu.system.gen_server import GenerationServer as JServer
from areal_tpu_torch.api.data_api import MicroBatchSpec
from areal_tpu_torch.base import faults as tfaults
from areal_tpu_torch.base import integrity as tint
from areal_tpu_torch.engines.generator import GeneratorEngine
from areal_tpu_torch.models.config import tiny_config
from areal_tpu_torch.models.weights import params_from_numpy, params_to_numpy
from areal_tpu_torch.ops import functional as tF
from areal_tpu_torch.system.gen_server import GenerationServer
from areal_tpu_torch.system.transfer import InProcTransfer
from tests.test_torch_sentinels import SFT, _engines, _sft_samples
from tests.test_torch_train import _flat
from tests.test_torch_transfer import _push, _push_workers

torch.set_num_threads(2)

EOS = 7


# ---------------- FaultInjector.poison ----------------

POISON_SPECS = [
    "nan@point=train_grads",
    "nan@point=train_grads&skip=2",
    "nan@point=train_grads&skip=1&times=2",
    "corrupt_push@point=weight_push&times=1",
    "corrupt_push@point=weight_push&p=0.5",
    "nan@point=train_grads&p=0.3&skip=1&times=3 corrupt_push@point=weight_push&skip=2",
    "slow@ms=1&point=train_grads kill@point=train_grads nan@point=train_grads&times=2",
]


@pytest.mark.parametrize("spec", POISON_SPECS)
def test_poison_matches_jax(spec):
    """The same seeded call sequence over both data boundaries (and an
    unrelated point) gives the same verdicts and `fired` counts; `fire`
    and `kill_point` at the same boundary never consume a poison."""
    rng = np.random.default_rng(5)
    points = [("train_grads", "weight_push", "generate")[i] for i in rng.integers(0, 3, 40)]
    verdicts = {}
    for name, mod in (("port", tfaults), ("jax", jfaults)):
        inj = mod.FaultInjector.parse(spec, seed=3, hang_max_s=1.0)
        seen = []
        for point in points:
            seen.append(inj.poison(point))
        verdicts[name] = (seen, dict(inj.fired))
    assert verdicts["port"] == verdicts["jax"]
    assert any(v is not None for v in verdicts["port"][0]) or "p=" in spec


@pytest.mark.parametrize("mod", [tfaults, jfaults], ids=["port", "jax"])
def test_fire_never_applies_a_poison_kind(mod):
    inj = mod.FaultInjector.parse("corrupt_push@point=weight_push nan@point=train_grads")
    inj.fire("weight_push")
    inj.fire("train_grads")
    assert inj.fired["corrupt_push"] == inj.fired["nan"] == 0
    assert inj.poison("weight_push") == "corrupt_push"
    assert inj.poison("train_grads") == "nan"


def test_poison_calls_on_fire():
    kinds = []
    inj = tfaults.FaultInjector.parse("nan@point=train_grads&times=1", on_fire=kinds.append)
    assert inj.poison("train_grads") == "nan" and inj.poison("train_grads") is None
    assert kinds == ["nan"]


# ---------------- integrity.corrupt_params ----------------


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "embed": rng.standard_normal((6, 4)).astype(np.float32),
        "blocks": {"wq": rng.standard_normal((2, 4, 4)).astype(np.float32),
                   "ids": np.arange(5, dtype=np.int32)},
        "a_int": np.arange(3, dtype=np.int64),
    }


@pytest.mark.parametrize("seed", [0, 1])
def test_corrupt_params_matches_jax_bytes(seed):
    """The same numpy tree corrupts to the same bytes in both packages
    (the first floating leaf in sorted-key order), and the caller's
    leaves stay as they were."""
    tree = _tree(seed)
    keep = {k: v.copy() for k, v in _flat(tree).items()}
    want = _flat(jint.corrupt_params(tree))
    got = _flat(tint.corrupt_params(tree))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k
    assert not np.array_equal(got["blocks/wq"], keep["blocks/wq"])  # "blocks" sorts first
    for k, v in _flat(tree).items():
        np.testing.assert_array_equal(v, keep[k])


def test_corrupt_params_on_tensors_keeps_the_input():
    tree = params_from_numpy(_tree(2), device="cpu")
    before = {k: v.copy() for k, v in _flat(params_to_numpy(tree)).items()}
    bad = tint.corrupt_params(tree)
    assert list(bad) == list(tree)  # the caller's key order
    np.testing.assert_array_equal(
        bad["blocks"]["wq"].numpy(), before["blocks/wq"] * np.float32(1.5) + np.float32(1.0))
    for k, v in _flat(params_to_numpy(tree)).items():
        np.testing.assert_array_equal(v, before[k])
    assert bad["embed"] is tree["embed"]
    with pytest.raises(tint.WeightChecksumError):
        tint.verify_checksum(bad, tint.params_checksum(tree))


# ---------------- NaN-poisoned gradients in the train engine ----------------


@pytest.fixture(scope="module")
def weights():
    return jax.tree.map(np.asarray, jtfm.init_params(jtiny(), jax.random.PRNGKey(5)))


def _poisoned_engines(weights, monkeypatch, spec="nan@point=train_grads&times=1"):
    monkeypatch.setenv("AREAL_FAULTS", spec)
    je, te = _engines(weights, lr=1e-3)
    monkeypatch.delenv("AREAL_FAULTS")
    return je, te


def _state(te):
    return [{k: v.copy() for k, v in _flat(params_to_numpy(t)).items()}
            for t in (te.params, te._mu, te._nu)]


def _assert_state_equal(te, before):
    for snap, tree in zip(before, (te.params, te._mu, te._nu)):
        for k, v in _flat(params_to_numpy(tree)).items():
            np.testing.assert_array_equal(v, snap[k], err_msg=k)


def _assert_close(got, want):
    assert set(got) == set(want)
    for k in want:
        tol = 1e-4 if k.endswith("norm") else 1e-5
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=1e-7, err_msg=k)


def _assert_weights_close(je, te, lr):
    pj, pt = _flat(je.get_params()), _flat(params_to_numpy(te.get_params()))
    for k in pj:
        np.testing.assert_allclose(pt[k], pj[k], atol=lr / 100, rtol=0, err_msg=k)


def test_nan_grads_in_train_batch_match_jax(weights, monkeypatch):
    """`nan@point=train_grads&times=1`: the first train_batch is
    quarantined in both engines with the same verdict bits, the port's
    masters, moments and count bit for bit unchanged; the next, clean
    step is held to JAX's (test_torch_train's tolerances)."""
    je, te = _poisoned_engines(weights, monkeypatch)
    ts, js = _sft_samples(seed=1)
    before, count0 = _state(te), te.opt_count
    want = je.train_batch(js, JMicroBatchSpec(), jF.sft_loss, jF.sft_label_count, **SFT)
    got = te.train_batch(ts, MicroBatchSpec(), tF.sft_loss, tF.sft_label_count, **SFT)
    assert got["anomaly_verdict"] == want["anomaly_verdict"] == tint.NONFINITE
    assert got["quarantined"] == want["quarantined"] == 1.0
    assert te._faults.fired["nan"] == je._faults.fired["nan"] == 1
    _assert_state_equal(te, before)
    assert te.opt_count == count0 and te.host_transfers == 1
    ts, js = _sft_samples(seed=2)
    want = je.train_batch(js, JMicroBatchSpec(), jF.sft_loss, jF.sft_label_count, **SFT)
    got = te.train_batch(ts, MicroBatchSpec(), tF.sft_loss, tF.sft_label_count, **SFT)
    assert got["quarantined"] == want["quarantined"] == 0.0
    _assert_close(got, want)
    _assert_weights_close(je, te, 1e-3)
    assert te.opt_count == count0 + 1 and te.host_transfers == 2


def test_nan_grads_in_train_stream_end_match_jax(weights, monkeypatch):
    """The same through the streamed step: two chunks, the poison at
    `train_stream_end`; then a clean stream held to JAX's."""
    je, te = _poisoned_engines(weights, monkeypatch)

    def stream(eng, sample, mb, loss, weight):
        state = eng.train_stream_begin()
        for c in sample.split_balanced(2):
            eng.train_stream_chunk(state, c, mb, loss, weight, **SFT)
        return eng.train_stream_end(state)

    ts, js = _sft_samples(seed=3)
    before = _state(te)
    want = stream(je, js, JMicroBatchSpec(), jF.sft_loss, jF.sft_label_count)
    got = stream(te, ts, MicroBatchSpec(), tF.sft_loss, tF.sft_label_count)
    assert got["anomaly_verdict"] == want["anomaly_verdict"] == tint.NONFINITE
    assert got["quarantined"] == want["quarantined"] == 1.0
    _assert_state_equal(te, before)
    assert te.opt_count == 0
    ts, js = _sft_samples(seed=4)
    want = stream(je, js, JMicroBatchSpec(), jF.sft_loss, jF.sft_label_count)
    got = stream(te, ts, MicroBatchSpec(), tF.sft_loss, tF.sft_label_count)
    _assert_close(got, want)
    _assert_weights_close(je, te, 1e-3)


def test_no_fault_no_injector(weights):
    _, te = _engines(weights)
    assert te._faults is None


# ---------------- the generation server's fault points ----------------


@pytest.fixture(scope="module")
def gen_weights():
    return jax.tree.map(np.asarray, jtfm.init_params(jtiny(), jax.random.PRNGKey(11)))


def _servers(gen_weights, spec, **kw):
    """A port server and a JAX server over the same weights, each with
    its own injector parsed from `spec`."""
    mesh = make_mesh(ParallelConfig.from_str("d1"), jax.devices()[:1])
    port = GenerationServer(
        GeneratorEngine(tiny_config(), params_from_numpy(gen_weights, device="cpu"), "cpu",
                        eos_token_id=EOS),
        faults=tfaults.FaultInjector.parse(spec, hang_max_s=30.0) if spec else None, **kw)
    jsrv = JServer(
        JEngine(jtiny(), jax.tree.map(jax.numpy.asarray, gen_weights), mesh, eos_token_id=EOS),
        zmq_port=None,
        faults=jfaults.FaultInjector.parse(spec, hang_max_s=30.0) if spec else None, **kw)
    return {"port": port, "jax": jsrv}


def _post(url, payload, timeout=60):
    import json

    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def test_error_at_generate_reaches_the_client_as_in_jax(gen_weights):
    """`error@point=generate&times=1`: the first /generate gets the same
    HTTP status from both servers, the second is served."""
    servers = _servers(gen_weights, "error@point=generate&times=1")
    codes = {}
    try:
        for name, srv in servers.items():
            body = {"qid": "q", "prompt_ids": [9, 10, 11], "max_new_tokens": 3, "greedy": True}
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(srv.url + "/generate", body)
            codes[name] = e.value.code
            status, out = _post(srv.url + "/generate", dict(body, qid="q2"))
            assert status == 200 and len(out["output_ids"][0]) == 3
            assert srv._faults.fired["error"] == 1
    finally:
        for srv in servers.values():
            srv.close()
    assert codes["port"] == codes["jax"] == 500


def test_slow_health_as_in_jax(gen_weights):
    """`slow@ms=300&point=health&times=1`: the first /health of each
    server takes the delay, the second does not."""
    servers = _servers(gen_weights, "slow@ms=300&point=health&times=1")
    try:
        for name, srv in servers.items():
            waits = []
            for _ in range(2):
                t0 = time.monotonic()
                with urllib.request.urlopen(srv.url + "/health", timeout=30) as r:
                    assert r.status == 200
                waits.append(time.monotonic() - t0)
            assert waits[0] >= 0.3 and waits[1] < 0.3, (name, waits)
            assert srv._faults.fired["slow"] == 1
    finally:
        for srv in servers.values():
            srv.close()


def test_hang_at_param_push_is_released_by_close(gen_weights):
    """`hang@point=param_push`: a push hangs in each server until
    `close()`, which fails it at once (FaultError), not at the cap."""
    servers = _servers(gen_weights, "hang@point=param_push")
    for name, srv in servers.items():
        mod = tfaults if name == "port" else jfaults
        out = {}

        def push():
            try:
                srv._handle_param_push({"version": 1, "manifest": []}, b"")
            except Exception as e:  # noqa: BLE001 — the verdict under test
                out["error"] = e

        th = threading.Thread(target=push)
        th.start()
        deadline = time.monotonic() + 30
        while srv._faults.fired["hang"] == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert th.is_alive() and srv._faults.fired["hang"] == 1, name
        t0 = time.monotonic()
        srv.close()
        th.join(timeout=10)
        assert not th.is_alive() and time.monotonic() - t0 < 10, name
        assert isinstance(out.get("error"), mod.FaultError), (name, out)
        assert srv.version == 0


def test_corrupted_inmem_push_is_refused_then_retried_as_in_jax(gen_weights):
    """`corrupt_push@point=weight_push&times=1`: the first in-memory push
    of checksummed weights is refused by both servers (each package's
    rejection counter +1, the version unchanged), the retry lands, and
    each server then serves exactly the pushed weights."""
    new = jax.tree.map(np.asarray, jtfm.init_params(jtiny(), jax.random.PRNGKey(99)))
    checksum = jint.params_checksum(new)
    servers = _servers(gen_weights, "corrupt_push@point=weight_push&times=1")
    counters = {"port": tint.M_PUSH_REJECTED, "jax": jint.M_PUSH_REJECTED}
    pushed = {"port": lambda: params_from_numpy(new, device="cpu"),
              "jax": lambda: jax.tree.map(jax.numpy.asarray, new)}
    errors = {"port": tint.WeightChecksumError, "jax": jint.WeightChecksumError}
    try:
        for name, srv in servers.items():
            rej0 = counters[name].get()
            with pytest.raises(errors[name]):
                srv.update_weights_inmem(pushed[name](), checksum=checksum)
            assert counters[name].get() - rej0 == 1 and srv.version == 0
            assert srv.update_weights_inmem(pushed[name](), checksum=checksum) == 1
            assert counters[name].get() - rej0 == 1
            assert srv._faults.fired["corrupt_push"] == 1
        served = _flat(params_to_numpy(servers["port"].engine.params))
        for k, v in _flat(new).items():
            np.testing.assert_array_equal(served[k], v, err_msg=k)
        jserved = _flat(servers["jax"].engine.params)
        for k, v in _flat(new).items():
            np.testing.assert_array_equal(np.asarray(jserved[k], np.float32), v, err_msg=k)
    finally:
        for srv in servers.values():
            srv.close()


# ---------------- the worker's poisoned param_send ----------------


def test_poisoned_param_send_is_refused_and_the_cache_stays_clean(monkeypatch):
    """`corrupt_push@point=weight_push&times=1` on the sender: the first
    send carries the JAX package's corruption of the clean host tree (the
    same bytes) under the clean checksum, which the receiver refuses with
    its weights unchanged; the cached encoding stays the clean one, and
    the retry reuses it and lands."""
    from areal_tpu_torch.system.transfer import encode_oob

    ps = InProcTransfer.make_group(2)
    monkeypatch.setenv("AREAL_FAULTS", "corrupt_push@point=weight_push&times=1")
    src, dst = _push_workers(ps)
    monkeypatch.delenv("AREAL_FAULTS")
    gen = dst.models["actor_gen@0"].engine
    before = {k: v.copy() for k, v in _flat(params_to_numpy(gen.params)).items()}
    sent = src.handle_request({"type": "param_send", "model_name": "actor@0", "dsts": [1],
                               "xfer_ids": [0], "checksum": True})
    xid, (kind, bad, checksum) = ps[1].recv(timeout=30)
    assert xid == 0 and kind == "params" and sent["bytes"] > 0
    cache = src._param_send_cache["actor@0"]
    _, clean, clean_checksum = cache["payload"]
    assert np.array_equal(checksum, clean_checksum)
    want = _flat(jint.corrupt_params(clean))
    for k, v in _flat(bad).items():
        assert v.tobytes() == want[k].tobytes(), k
    assert cache["encoded"][0] == encode_oob(cache["payload"])[0]  # the clean encoding
    ps[0].send(1, 1, ("params", bad, checksum))
    with pytest.raises(tint.WeightChecksumError):
        dst.handle_request({"type": "param_recv", "model_name": "actor_gen@0", "xfer_id": 1})
    for k, v in _flat(params_to_numpy(gen.params)).items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)
    again, got = _push(src, dst, 2)
    assert again["gather_s"] == 0.0 and again["bytes"] == sent["bytes"]
    assert "load_s" in got
    actor = _flat(params_to_numpy(src.models["actor@0"].engine.get_params()))
    for k, v in _flat(params_to_numpy(gen.params)).items():
        np.testing.assert_array_equal(v, actor[k], err_msg=k)
    assert src._faults.fired["corrupt_push"] == 1
