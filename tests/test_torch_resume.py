"""Interrupt and resume of the port's serving plane, against its own
uninterrupted run and against the JAX package's engine on the CPU, one
set of tiny_config weights (`kv_page_size=8, prefill_chunk_tokens=4,
max_decode_batch=2`, an EOS no token reaches, so every row decodes its
whole budget and the interrupt lands mid-flight):

- interrupted at the second serving chunk and resumed under UNCHANGED
  weights, greedy tokens equal the uninterrupted run's (twin of
  tests/test_rollout.py's interrupt test), also while followers map
  shared prompt pages, and the replay rewrites no shared page (twin of
  tests/test_paged_kv.py's shared-pages resume test);
- interrupted at chunk 2, given the same NEW weights and resumed, the
  port and the JAX engine emit identical greedy tokens, logprobs within
  1e-5; the same over int8 page pools (`kv_cache_dtype="int8"` on both,
  the replay through K3's int8 form), logprobs within 1e-3;
- a resume with no live row replays nothing;
- `set_params` never aliases its source."""

import jax
import numpy as np
import pytest
import torch

from areal_tpu.api.data_api import MicroBatchSpec as JSpec
from areal_tpu.api.data_api import SequenceSample as JSample
from areal_tpu.api.model_api import GenerationHyperparameters as JGen
from areal_tpu.base.topology import ParallelConfig, make_mesh
from areal_tpu.engines.generator import GeneratorEngine as JEngine
from areal_tpu.models import transformer as jtfm
from areal_tpu.models.config import tiny_config as jtiny
from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model_api import GenerationHyperparameters
from areal_tpu_torch.engines.generator import GeneratorEngine
from areal_tpu_torch.models.config import tiny_config
from areal_tpu_torch.models.weights import params_from_numpy

torch.set_num_threads(2)

KW = dict(kv_page_size=8, prefill_chunk_tokens=4, max_decode_batch=2)
# The 300-token prompt is still prefilling when the second chunk ends
# (at most 4 prompt tokens a row per inner step, 32 inner steps a chunk).
LONG = (5, 7, 300, 4, 19)
NO_EOS = tiny_config().vocab_size + 7


@pytest.fixture(scope="module")
def weights():
    """(JAX params, numpy params) of the old and the new weights."""
    old = jtfm.init_params(jtiny(), jax.random.PRNGKey(5))
    new = jtfm.init_params(jtiny(), jax.random.PRNGKey(99))
    return {
        name: (p, jax.tree.map(np.asarray, p)) for name, p in (("old", old), ("new", new))
    }


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(ParallelConfig.from_str("d1"), jax.devices()[:1])


def _samples(lens, seed=3):
    rng = np.random.default_rng(seed)
    data = np.concatenate(
        [rng.integers(8, jtiny().vocab_size, size=l) for l in lens]
    ).astype(np.int32)
    kw = dict(
        keys={"packed_prompts"}, ids=[f"p{i}" for i in range(len(lens))],
        seqlens={"packed_prompts": [[l] for l in lens]},
    )
    return (
        JSample(data={"packed_prompts": data.copy()}, **kw),
        SequenceSample(data={"packed_prompts": data.copy()}, **kw),
    )


def _port_engine(np_params, **kw):
    return GeneratorEngine(
        tiny_config(), params_from_numpy(np_params, device="cpu"), "cpu",
        eos_token_id=NO_EOS, **KW, **kw,
    )


def _interrupt_at_chunk(eng, k=2):
    """Hook the serving-chunk getter so interrupt() is set while chunk k
    runs: the loop parks at the next chunk boundary."""
    real_get = eng._get_serving_chunk_fn
    calls = {"n": 0}

    def hooked(*a, **kw):
        fn = real_get(*a, **kw)

        def wrapped(*fa, **fkw):
            calls["n"] += 1
            if calls["n"] == k:
                eng.interrupt()
            return fn(*fa, **fkw)

        return wrapped

    eng._get_serving_chunk_fn = hooked
    return calls


def _assert_parked_mid_flight(st, prefilling=True):
    """The park found a row decoding and (unless told otherwise) a row
    still prefilling."""
    live = [s for s in range(st.n_slots) if st.active[s] is not None]
    assert any(st.prefill_rem[s] == 0 for s in live), "no decoding row"
    if prefilling:
        assert any(st.prefill_rem[s] > 0 for s in live), "no row mid-prefill"


def _assert_same(a, b, atol=0.0):
    assert a.seqlens["packed_input_ids"] == b.seqlens["packed_input_ids"]
    np.testing.assert_array_equal(
        np.asarray(a.data["packed_input_ids"]), np.asarray(b.data["packed_input_ids"])
    )
    np.testing.assert_allclose(
        np.asarray(a.data["packed_logprobs"]), np.asarray(b.data["packed_logprobs"]),
        atol=atol, rtol=0,
    )


def test_interrupted_resume_is_token_identical(weights):
    """Twin of tests/test_rollout.py's TestInterruptResumeParity: parked
    at chunk 2 with rows both decoding and mid-prefill, resumed under
    unchanged weights, the tokens equal the uninterrupted run's."""
    _, ts = _samples(LONG)
    g = GenerationHyperparameters(n=1, max_new_tokens=80, greedy=True)
    ref = _port_engine(weights["old"][1]).generate(ts, MicroBatchSpec(), g, seed=0)
    eng = _port_engine(weights["old"][1])
    calls = _interrupt_at_chunk(eng)
    assert eng.generate(ts, MicroBatchSpec(), g, seed=0) is None
    assert eng.interrupted and eng.interrupt_requested and calls["n"] == 2
    _assert_parked_mid_flight(eng._session)
    # A new call is refused while a session is parked.
    with pytest.raises(RuntimeError, match="parked"):
        eng.generate(ts, MicroBatchSpec(), g, seed=0)
    eng.clear_interrupt()
    out = eng.resume_generate()
    assert out is not None and eng.resume_replays == 1 and not eng.interrupted
    _assert_same(ref, out)


def test_resume_before_any_admission_replays_nothing(weights):
    """An interrupt already pending when generate() starts parks it before
    any slot is admitted: the resume has no live row, runs no replay
    (resume_replays stays 0, unlike the reference's count of resumes)
    and the tokens equal the uninterrupted run's."""
    _, ts = _samples((5, 7))
    g = GenerationHyperparameters(n=1, max_new_tokens=12, greedy=True)
    # Two requests fit a static chunk, which cannot park: ask for the
    # serving plane.
    ref = _port_engine(weights["old"][1]).generate(
        ts, MicroBatchSpec(), g, seed=0, inflight=True
    )
    eng = _port_engine(weights["old"][1])
    eng.interrupt()
    assert eng.generate(ts, MicroBatchSpec(), g, seed=0, inflight=True) is None
    assert all(a is None for a in eng._session.active)
    eng.clear_interrupt()
    out = eng.resume_generate()
    assert out is not None and eng.resume_replays == 0 and not eng.interrupted
    _assert_same(ref, out)
    with pytest.raises(RuntimeError, match="no interrupted generation"):
        eng.resume_generate()


def test_resume_with_shared_pages_rewrites_none(weights):
    """Twin of tests/test_paged_kv.py's shared-pages resume test: n=4
    responses map the owner's full prompt pages; parked at chunk 2 with a
    follower mapping them, resumed under unchanged weights, the tokens
    equal the uninterrupted run's and the replay leaves every shared page
    as it was."""
    _, ts = _samples((17, 9))
    g = GenerationHyperparameters(n=4, max_new_tokens=24, greedy=True)
    ref = _port_engine(weights["old"][1]).generate(ts, MicroBatchSpec(), g, seed=0)
    eng = _port_engine(weights["old"][1])
    _interrupt_at_chunk(eng)
    assert eng.generate(ts, MicroBatchSpec(), g, seed=0) is None
    st = eng._session
    followers = [
        s for s in range(st.n_slots)
        if st.active[s] is not None and int(st.shared_from[s]) > 0
    ]
    assert followers and any(st.alloc.is_shared(s, 0) for s in followers)
    shared = sorted({
        int(st.alloc.table[s, j]) for s in followers
        for j in range(int(st.shared_from[s]) // st.alloc.page_size)
    })
    snap = {}
    real_replay = eng._get_paged_replay_fn

    def checked_replay():
        fn = real_replay()

        def wrapped(*a):
            snap["before"] = [st.pool.k[:, shared].clone(), st.pool.v[:, shared].clone()]
            fn(*a)
            snap["after"] = [st.pool.k[:, shared].clone(), st.pool.v[:, shared].clone()]

        return wrapped

    eng._get_paged_replay_fn = checked_replay
    eng.clear_interrupt()
    out = eng.resume_generate()
    assert out is not None and eng.resume_replays == 1
    for a, b in zip(snap["before"], snap["after"]):
        assert torch.equal(a, b)
    _assert_same(ref, out)


def _resume_under_new_weights(weights, mesh, n, lens, atol, **ekw):
    """Park both engines (options `ekw` on each) at chunk 2, hand them the
    same new weights through set_params, resume, and hold the port's
    tokens and logprobs against the JAX engine's."""
    js, ts = _samples(lens)
    g = dict(n=n, max_new_tokens=80, greedy=True)
    je = JEngine(jtiny(), weights["old"][0], mesh, eos_token_id=NO_EOS, kv_paged=True,
                 **KW, **ekw)
    te = _port_engine(weights["old"][1], **ekw)
    _interrupt_at_chunk(je)
    _interrupt_at_chunk(te)
    assert je.generate(js, JSpec(), JGen(**g), seed=0) is None
    assert te.generate(ts, MicroBatchSpec(), GenerationHyperparameters(**g), seed=0) is None
    # n > 1: the parked rows are an owner and a follower mapping its
    # prompt pages, both decoding.
    _assert_parked_mid_flight(te._session, prefilling=n == 1)
    if n == 4:
        # Two followers wait with their prompt's pages in the prefix
        # cache: after the push they must re-prefill under the new
        # weights, not map the pre-push pages.
        st = te._session
        assert st.pending and all(
            np.asarray(t, np.int32).tobytes() in st.alloc._prefix_cache
            for _, _, t in st.pending
        )
    je.set_params(weights["new"][0])
    te.set_params(params_from_numpy(weights["new"][1], device="cpu"))
    je.clear_interrupt()
    te.clear_interrupt()
    oj, ot = je.resume_generate(), te.resume_generate()
    assert te.resume_replays == je.resume_replays == 1
    _assert_same(oj, ot, atol=atol)
    # The push changed what was generated after it.
    ref = _port_engine(weights["old"][1], **ekw).generate(
        ts, MicroBatchSpec(), GenerationHyperparameters(**g), seed=0
    )
    assert not np.array_equal(ref.data["packed_input_ids"], ot.data["packed_input_ids"])


@pytest.mark.parametrize("n,lens", [(1, LONG), (2, (17, 9)), (4, (17,))])
def test_resume_under_new_weights_matches_jax(weights, mesh, n, lens):
    """End to end: the port's engine and the JAX package's are
    each parked at chunk 2, handed the same new weights through
    set_params and resumed; their greedy tokens are identical and their
    logprobs agree within 1e-5."""
    _resume_under_new_weights(weights, mesh, n, lens, 1e-5)


@pytest.mark.parametrize("n,lens", [(1, LONG), (2, (17, 9)), (4, (17,))])
def test_resume_under_new_weights_int8_matches_jax(weights, mesh, n, lens):
    """As above over int8 page pools (kv_cache_dtype="int8" on both
    engines): the replay runs K3's chunk form over int8 codes and bf16
    scales.  Greedy tokens identical; logprobs within 1e-3, not 1e-5: the
    two packages compute each fresh K/V in fp32 with other roundings,
    and a value on a code boundary quantizes one step apart (see
    test_decode_step_spec_paged_matches_jax in test_torch_paged_chunk.py),
    which moves it by a whole step, amax / 127 of its row.  The largest
    difference read on the CPU was 1.7e-4 (n=1; 1.0e-4 for n=2 and 4)."""
    _resume_under_new_weights(weights, mesh, n, lens, 1e-3, kv_cache_dtype="int8")


def test_set_params_never_aliases_its_source(weights):
    """A same-dtype, same-device tree (a TrainEngine's fp32 masters on
    the CPU) changed in place after set_params leaves the engine's
    weights as they were."""
    src = params_from_numpy(weights["old"][1], device="cpu")
    eng = GeneratorEngine(
        tiny_config(), src, "cpu", eos_token_id=NO_EOS, compute_dtype=torch.float32, **KW
    )
    eng.set_params(src)
    before = eng.params["blocks"]["wq"].clone()
    with torch.no_grad():
        src["blocks"]["wq"].add_(1.0)
        src["embed"].mul_(2.0)
    assert torch.equal(eng.params["blocks"]["wq"], before)
    assert not torch.equal(eng.params["embed"], src["embed"])
