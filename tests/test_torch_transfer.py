"""The cross-worker planes (`system/transfer.py` and the worker's
data_send/data_recv and param_send/param_recv) against the JAX
package's: pickle protocol 5 with out-of-band buffers encodes as the
JAX package's `encode_oob` does and round-trips numpy pytrees over the
socket plane into writable arrays; transfers that arrive out of order
land with their own request (the stash of `_recv_xfer`); a
`SequenceSample` moves between two port workers intact; a weight push
lands the actor's weights in a generator, checksummed (a corrupted push
is refused and leaves the old weights), serialized once while the
weights are unchanged, and with eta < 1 mixes as the worker's colocated
EMA does."""

import pickle
import threading

import numpy as np
import pytest
import torch

from areal_tpu.system import transfer as jtransfer
from areal_tpu_torch.api.config import (
    ModelAbstraction,
    ModelBackendAbstraction,
    ModelInterfaceAbstraction,
    ModelName,
)
from areal_tpu_torch.api.data_api import DatasetAbstraction
from areal_tpu_torch.base import integrity, name_resolve
from areal_tpu_torch.models.config import tiny_config
from areal_tpu_torch.system.transfer import (
    ConnTransfer,
    InProcTransfer,
    encode_oob,
    payload_nbytes,
)
from areal_tpu_torch.system.worker import ModelShardSpec, ModelWorker, WorkerConfig, ema_mix
from tests import fixtures

torch.set_num_threads(2)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "f32": rng.standard_normal((33, 7)).astype(np.float32),
        "i32": rng.integers(0, 100, (5,), dtype=np.int32),
        "nested": {"b": np.array([True, False]), "empty": np.zeros((0, 3), np.float16),
                   "fortran": np.asfortranarray(rng.standard_normal((4, 6)))},
        "list": [np.arange(10, dtype=np.int64), "text", 3.5],
    }


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_encoding_matches_jax():
    payload = ("data", _tree())
    meta, bufs = encode_oob(payload)
    jmeta, jbufs = jtransfer.encode_oob(payload)
    assert meta == jmeta
    assert [bytes(b.raw()) for b in bufs] == [bytes(b.raw()) for b in jbufs]
    assert payload_nbytes(meta, bufs) == jtransfer.payload_nbytes(jmeta, jbufs)
    assert len(bufs) >= 4  # the arrays went out of band
    _assert_tree_equal(pickle.loads(meta, buffers=bufs)[1], payload[1])


@pytest.fixture
def planes():
    name_resolve.set_default(name_resolve.MemoryNameResolveRepository())
    made = [ConnTransfer("xfer", "t0", i) for i in range(2)]
    yield made
    for p in made:
        p.close()


def test_socket_plane_round_trips_pytrees(planes):
    a, b = planes
    tree = _tree(1)
    n = a.send(1, 7, ("data", tree))
    assert n == payload_nbytes(*encode_oob(("data", tree)))
    assert InProcTransfer.make_group(2)[0].send(1, 7, ("data", tree)) == n
    xid, (kind, got) = b.recv(timeout=10)
    assert xid == 7 and kind == "data"
    _assert_tree_equal(got, tree)
    got["f32"][0, 0] = 1.0  # writable, as the in-process plane's arrays
    # Fan-out encodes once and counts the bytes of every target.
    enc = encode_oob(("data", tree))
    assert b.send_many([0, 0], [8, 9], ("data", tree), encoded=enc) == 2 * n
    assert sorted(a.recv(timeout=10)[0] for _ in range(2)) == [8, 9]
    with pytest.raises(TimeoutError):
        b.recv(timeout=0.1)


def _bare_worker(index, transfer, shards=(), datasets=()):
    cfg = WorkerConfig(worker_index=index, shards=list(shards), datasets=list(datasets),
                       batch_size=4, tokenizer_path="char:512")
    return ModelWorker(cfg, device="cpu", transfer=transfer)


def test_out_of_order_transfers_land(planes):
    """Three receivers wait at once for ids 5, 6, 7; the payloads arrive
    7, 5, 6: each request gets its own, whichever thread drained it."""
    a, b = planes
    w = _bare_worker(1, b)
    got = {}

    def recv(xid):
        got[xid] = w._recv_xfer(xid, timeout=20)

    threads = [threading.Thread(target=recv, args=(x,)) for x in (5, 6, 7)]
    for t in threads:
        t.start()
    for xid in (7, 5, 6):
        a.send(1, xid, ("data", {"xid": np.full((3,), xid)}))
    for t in threads:
        t.join(timeout=30)
    assert sorted(got) == [5, 6, 7]
    for xid, (_, payload) in got.items():
        np.testing.assert_array_equal(payload["xid"], np.full((3,), xid))
    assert w._xfer_stash == {}


def _math_dataset(tmp_path):
    import json

    path = tmp_path / "math.jsonl"
    with open(path, "w") as f:
        for r in fixtures.build_math_rows(8, seed=4):
            f.write(json.dumps(r) + "\n")
    return DatasetAbstraction("math_code_prompt", {"dataset_path": str(path), "max_length": 64})


@pytest.mark.parametrize("plane", ["socket", "inproc"])
def test_data_send_recv_moves_a_sample(tmp_path, planes, plane):
    ps = planes if plane == "socket" else InProcTransfer.make_group(2)
    src = _bare_worker(0, ps[0], datasets=[_math_dataset(tmp_path)])
    dst = _bare_worker(1, ps[1])
    meta = src.handle_request({"type": "fetch"})["meta"]
    ids = list(meta.ids)
    out = {}
    recv = threading.Thread(target=lambda: out.update(
        dst.handle_request({"type": "data_recv", "xfer_id": 3})))
    recv.start()
    sent = src.handle_request({"type": "data_send", "ids": ids, "keys": ["packed_prompts"],
                               "dst": 1, "xfer_id": 3})
    recv.join(timeout=30)
    assert out["n"] == len(ids) and sent["bytes"] > 0 and sent["seconds"] >= 0
    for sid in ids:
        a, b = src.data_cache[sid], dst.data_cache[sid]
        assert b.ids == a.ids and b.keys == {"packed_prompts"}
        assert b.seqlens["packed_prompts"] == a.seqlens["packed_prompts"]
        np.testing.assert_array_equal(b.data["packed_prompts"], a.data["packed_prompts"])


def _push_workers(ps, dst_backend="generator", dst_dtype="float32"):
    cfg = tiny_config()
    actor = ModelShardSpec(
        name=ModelName("actor", 0), model=ModelAbstraction("random", {"config": cfg}),
        backend=ModelBackendAbstraction("train", {}), interface=ModelInterfaceAbstraction("null"))
    other = dict(generator=("actor_gen", "generator"), inference=("ref", "inference"))
    role, btype = other[dst_backend]
    args = {"compute_dtype": getattr(torch, dst_dtype)} if btype == "inference" else {}
    dst = ModelShardSpec(
        name=ModelName(role, 0),
        model=ModelAbstraction("random", {"config": tiny_config(param_dtype=dst_dtype)}),
        backend=ModelBackendAbstraction(btype, args), interface=ModelInterfaceAbstraction("null"))
    return _bare_worker(0, ps[0], shards=[actor]), _bare_worker(1, ps[1], shards=[dst])


def _push(src, dst, xfer_id, eta=1.0, target="actor_gen@0"):
    out = {}
    recv = threading.Thread(target=lambda: out.update(dst.handle_request({
        "type": "param_recv", "model_name": target, "xfer_id": xfer_id, "eta": eta})))
    recv.start()
    sent = src.handle_request({"type": "param_send", "model_name": "actor@0", "dsts": [1],
                               "xfer_ids": [xfer_id], "checksum": True})
    recv.join(timeout=60)
    return sent, out


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("plane", ["socket", "inproc"])
def test_param_push_lands_checksummed_and_serializes_once(planes, plane):
    ps = planes if plane == "socket" else InProcTransfer.make_group(2)
    src, dst = _push_workers(ps)
    actor = src.models["actor@0"].engine
    sent, got = _push(src, dst, 0)
    assert sent["bytes"] > 4 * sum(p.numel() for _, p in _flat(actor.get_params()))
    assert "verify_s" in got and "load_s" in got
    gen = dict(_flat(dst.models["actor_gen@0"].engine.params))
    for k, v in _flat(actor.get_params()):
        assert torch.equal(gen[k], v), k
    # Unchanged weights: the second push reuses the encoding.
    again, _ = _push(src, dst, 1)
    assert again["gather_s"] == 0.0 and again["bytes"] == sent["bytes"]
    # An in-place update (as the optimizer does) invalidates it.
    with torch.no_grad():
        next(iter(dict(_flat(actor.params)).values())).add_(1.0)
    third, _ = _push(src, dst, 2)
    assert third["gather_s"] > 0.0
    gen = dict(_flat(dst.models["actor_gen@0"].engine.params))
    for k, v in _flat(actor.get_params()):
        assert torch.equal(gen[k], v), k


def test_corrupted_push_is_refused(planes):
    a, b = planes
    src, dst = _push_workers(planes)
    before = {k: v.clone() for k, v in _flat(dst.models["actor_gen@0"].engine.params)}
    host = {k: v for k, v in _flat(src.models["actor@0"].engine.get_params())}
    tree = {}
    for k, v in host.items():  # the pushed tree, rebuilt nested
        node = tree
        *path, leaf = k.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v.numpy().copy()
    checksum = integrity.params_checksum(tree)
    first = next(iter(tree))
    leaf = tree[first] if not isinstance(tree[first], dict) else next(iter(tree[first].values()))
    leaf *= 1.5  # corrupted in flight
    a.send(1, 4, ("params", tree, checksum))
    with pytest.raises(integrity.WeightChecksumError):
        dst.handle_request({"type": "param_recv", "model_name": "actor_gen@0", "xfer_id": 4})
    for k, v in _flat(dst.models["actor_gen@0"].engine.params):
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_push_ema_matches_colocated(planes, dtype):
    """eta < 1 across workers mixes each leaf exactly as the colocated
    `param_sync` does (`ema_mix`, the JAX package's weak-typed rounding)."""
    src, dst = _push_workers(planes, dst_backend="inference", dst_dtype=dtype)
    before = {k: v.clone() for k, v in _flat(dst.models["ref@0"].engine.get_params())}
    _push(src, dst, 0, eta=0.25, target="ref@0")
    actor = dict(_flat(src.models["actor@0"].engine.get_params()))
    for k, v in _flat(dst.models["ref@0"].engine.get_params()):
        assert torch.equal(v, ema_mix(actor[k], before[k], 0.25)), k
