"""The port's generation engine against the JAX package's on the CPU,
one set of tiny_config weights: `GeneratorEngine(kv_paged=True,
kv_page_size=8, prefill_chunk_tokens=4, max_decode_batch=2)`.

- The serving plane, `inflight=True` on the JAX side: greedy tokens are
  identical, behaviour logprobs agree within 1e-4, and the lane /
  page-sharing counters are equal (twins of the serving-plane tests in
  tests/test_paged_kv.py).
- The static path, `inflight=False` on both sides: greedy tokens
  identical, logprobs within 1e-4, `seq_no_eos_mask` equal,
  `min_new_tokens` honoured; it equals the port's serving plane on
  greedy tokens (twin of tests/test_generator.py's static/inflight
  test); both engines choose the same path for the same call."""

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
from areal_tpu_torch.engines.paging import PagePoolExhausted
from areal_tpu_torch.models.config import tiny_config
from areal_tpu_torch.models.weights import params_from_numpy

torch.set_num_threads(2)

EOS = 7
KW = dict(kv_page_size=8, prefill_chunk_tokens=4, max_decode_batch=2)
LENS = (4, 11, 6, 9, 5)
COUNTERS = (
    "lanes_dispatched", "lanes_live", "lanes_slack", "dead_live_lanes",
    "decode_compiles", "prefill_dispatches", "serving_lane_budget",
)


@pytest.fixture(scope="module")
def weights():
    pj = jtfm.init_params(jtiny(), jax.random.PRNGKey(11))
    return pj, params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(ParallelConfig.from_str("d1"), jax.devices()[:1])


def _samples(lens, seed=42):
    rng = np.random.default_rng(seed)
    data = np.concatenate(
        [rng.integers(8, 512, size=l) for l in lens]
    ).astype(np.int32)
    kw = dict(
        keys={"packed_prompts"}, ids=[f"p{i}" for i in range(len(lens))],
        seqlens={"packed_prompts": [[l] for l in lens]},
    )
    return (
        JSample(data={"packed_prompts": data.copy()}, **kw),
        SequenceSample(data={"packed_prompts": data.copy()}, **kw),
    )


def _run_pair(weights, mesh, lens, n, max_new=8, jax_kw=None, port_kw=None, **g):
    pj, pt = weights
    js, ts = _samples(lens)
    je = JEngine(jtiny(), pj, mesh, eos_token_id=EOS, kv_paged=True,
                 **KW, **(jax_kw or {}))
    te = GeneratorEngine(tiny_config(), pt, "cpu", eos_token_id=EOS,
                         **KW, **(port_kw or {}))
    oj = je.generate(js, JSpec(), JGen(n=n, max_new_tokens=max_new, **g), inflight=True)
    ot = te.generate(ts, MicroBatchSpec(),
                     GenerationHyperparameters(n=n, max_new_tokens=max_new, **g))
    return je, te, oj, ot


def _assert_same(oj, ot, atol=1e-4):
    assert oj.seqlens["packed_input_ids"] == ot.seqlens["packed_input_ids"]
    np.testing.assert_array_equal(
        ot.data["packed_input_ids"], np.asarray(oj.data["packed_input_ids"])
    )
    np.testing.assert_allclose(
        ot.data["packed_logprobs"], np.asarray(oj.data["packed_logprobs"]),
        atol=atol, rtol=0,
    )
    np.testing.assert_array_equal(
        ot.data["seq_no_eos_mask"], np.asarray(oj.data["seq_no_eos_mask"])
    )
    np.testing.assert_array_equal(
        ot.data["prompt_mask"], np.asarray(oj.data["prompt_mask"])
    )


def test_greedy_n1_token_identical(weights, mesh):
    je, te, oj, ot = _run_pair(weights, mesh, LENS, n=1, greedy=True)
    _assert_same(oj, ot)
    for c in COUNTERS:
        assert getattr(te, c) == getattr(je, c), c
    assert te.decode_compiles == 1 and te.prefill_dispatches == 0


def test_group_sampling_shares_prompt_pages(weights, mesh):
    """n=4 same-prompt responses: identical tokens, and the followers map
    the owner's full prompt pages (prefix hits, zero CoW copies) exactly
    as the JAX serving plane does."""
    je, te, oj, ot = _run_pair(weights, mesh, (17, 9), n=4, greedy=True)
    _assert_same(oj, ot)
    for c in COUNTERS:
        assert getattr(te, c) == getattr(je, c), c
    for k in ("shared_mappings", "prefix_hits", "prefix_misses", "cow_copies",
              "peak_pages_used", "pages_recycled", "pool_pages"):
        assert te.last_pool_stats[k] == je.last_pool_stats[k], k
    assert te.last_pool_stats["shared_mappings"] > 0
    assert te.last_pool_stats["cow_copies"] == 0


def test_share_disabled_still_token_identical(weights, mesh):
    je, te, oj, ot = _run_pair(
        weights, mesh, (17, 9), n=4, greedy=True,
        jax_kw=dict(kv_share_prefix=False), port_kw=dict(kv_share_prefix=False),
    )
    _assert_same(oj, ot)
    assert te.last_pool_stats["shared_mappings"] == 0
    assert te.lanes_live == je.lanes_live


def test_int8_pool_rides_serving_plane(weights, mesh):
    je, te, oj, ot = _run_pair(
        weights, mesh, LENS, n=1, greedy=True,
        jax_kw=dict(kv_cache_dtype="int8"), port_kw=dict(kv_cache_dtype="int8"),
    )
    # Tokens identical; logprobs within 1e-3, not 1e-4: a fresh K/V value
    # on a rounding edge quantizes one int8 step apart when the two
    # packages' fp32 projections differ in the last bit.
    _assert_same(oj, ot, atol=1e-3)
    assert te.decode_compiles == 1


def test_lane_accounting_dead_lanes_zero(weights, mesh):
    """Every dispatched lane is live or budgeted slack, the live-but-
    misassigned count is exactly 0, and all counters equal JAX's."""
    je, te, _, _ = _run_pair(weights, mesh, LENS, n=2, max_new=10, greedy=True)
    assert te.lanes_dispatched > 0
    assert 0 < te.lanes_live <= te.lanes_dispatched
    assert te.lanes_live + te.lanes_slack == te.lanes_dispatched
    assert te.dead_live_lanes == 0
    for c in COUNTERS:
        assert getattr(te, c) == getattr(je, c), c


def test_stop_and_min_new_tokens_match(weights, mesh):
    """Host-side stop sequences and the in-chunk min_new_tokens EOS mask
    behave as in the JAX package."""
    _, _, oj, _ = _run_pair(weights, mesh, (6, 9), n=1, max_new=12, greedy=True)
    gen = np.asarray(oj.data["packed_input_ids"])[6:6 + 4]  # a real 2-gram
    stop = ((int(gen[2]), int(gen[3])),)
    _, _, oj, ot = _run_pair(
        weights, mesh, (6, 9), n=1, max_new=12, greedy=True, stop=stop,
    )
    _assert_same(oj, ot)
    _, _, oj, ot = _run_pair(
        weights, mesh, (6, 9), n=2, max_new=6, greedy=True, min_new_tokens=4,
    )
    _assert_same(oj, ot)


def test_sampling_is_seeded_and_well_formed(weights):
    _, pt = weights
    _, ts = _samples((7, 12))
    eng = GeneratorEngine(tiny_config(), pt, "cpu", eos_token_id=EOS, **KW)
    g = GenerationHyperparameters(n=3, max_new_tokens=10, temperature=0.9, top_p=0.95)
    a = eng.generate(ts, MicroBatchSpec(), g, seed=5)
    b = eng.generate(ts, MicroBatchSpec(), g, seed=5)
    c = eng.generate(ts, MicroBatchSpec(), g, seed=6)
    np.testing.assert_array_equal(a.data["packed_input_ids"], b.data["packed_input_ids"])
    assert not np.array_equal(a.data["packed_input_ids"], c.data["packed_input_ids"])
    lp = a.data["packed_logprobs"]  # 0 on prompt positions
    assert np.isfinite(lp).all() and (lp <= 0).all()
    assert a.data["packed_input_ids"].max() < 512
    assert eng.decode_compiles == 1


def test_small_pool_waits_for_pages(weights, mesh):
    """An explicitly sized pool smaller than the worst case: admission
    waits for retired slots' pages, with the JAX package's tokens."""
    je, te, oj, ot = _run_pair(
        weights, mesh, LENS, n=1, greedy=True,
        jax_kw=dict(kv_pool_pages=4), port_kw=dict(kv_pool_pages=4),
    )
    _assert_same(oj, ot)
    assert te.last_pool_stats["pages_recycled"] == je.last_pool_stats["pages_recycled"] > 0
    _, ts = _samples((40,))
    # One request fits a static chunk, which has no page pool: ask for
    # the serving plane, whose pool is too small for it.
    with pytest.raises(PagePoolExhausted):
        GeneratorEngine(tiny_config(), weights[1], "cpu", eos_token_id=EOS,
                        kv_pool_pages=2, **KW).generate(
            ts, MicroBatchSpec(), GenerationHyperparameters(max_new_tokens=4),
            inflight=True,
        )


def test_unported_paths_raise(weights):
    """Agent episodes (ROADMAP queue 1, item 5.4) still raise.  The modes
    of items 5.1-5.3, which raised here before, now run and give the
    serving plane's greedy tokens: speculative decoding, the dense window
    (kv_paged=False) and the two-program admit path
    (prefill_chunk_tokens=0)."""
    _, pt = weights
    _, ts = _samples((5, 9))
    eng = GeneratorEngine(tiny_config(), pt, "cpu", eos_token_id=EOS, **KW)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 5.4"):
        eng.episode_start()
    g = GenerationHyperparameters(max_new_tokens=6, greedy=True)
    want = eng.generate(ts, MicroBatchSpec(), g, inflight=True)
    outs = [eng.generate(ts, MicroBatchSpec(), g.new(spec_decode_k=2))]
    for kw in (dict(kv_paged=False), dict(prefill_chunk_tokens=0)):
        e = GeneratorEngine(tiny_config(), pt, "cpu", eos_token_id=EOS,
                            **dict(KW, **kw))
        outs.append(e.generate(ts, MicroBatchSpec(), g, inflight=True))
    for out in outs:
        np.testing.assert_array_equal(
            out.data["packed_input_ids"], want.data["packed_input_ids"]
        )


def test_default_device_is_the_card(weights):
    """device=None means CUDA: without a card the engine refuses to start
    rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        GeneratorEngine(tiny_config(), weights[1], eos_token_id=EOS)


# --------------------------------------------------------------------------
# The static path
# --------------------------------------------------------------------------


def _static_pair(weights, mesh, lens, n, max_new, eos=EOS, **g):
    pj, pt = weights
    js, ts = _samples(lens)
    je = JEngine(jtiny(), pj, mesh, eos_token_id=eos, kv_paged=True, **KW)
    te = GeneratorEngine(tiny_config(), pt, "cpu", eos_token_id=eos, **KW)
    oj = je.generate(js, JSpec(), JGen(n=n, max_new_tokens=max_new, **g), inflight=False)
    ot = te.generate(ts, MicroBatchSpec(),
                     GenerationHyperparameters(n=n, max_new_tokens=max_new, **g),
                     inflight=False)
    return je, te, oj, ot


def _response_lens(out, prompt_lens, n):
    return [
        full - prompt_lens[i]
        for i, row in enumerate(out.seqlens["packed_input_ids"]) for full in row
    ][: len(prompt_lens) * n]


def test_static_path_matches_jax_static(weights, mesh):
    """5 requests in length-sorted chunks of max_decode_batch=2 (three
    programs): greedy tokens identical, logprobs within 1e-4, the no-EOS
    mask and prompt mask equal; the engine counters read JAX's after a
    static call; one prefill per chunk and one decode step per token
    but the last."""
    max_new = 8
    je, te, oj, ot = _static_pair(weights, mesh, LENS, n=1, max_new=max_new, greedy=True)
    _assert_same(oj, ot)
    for c in COUNTERS:
        assert getattr(te, c) == getattr(je, c), c
    assert te.last_pool_stats == je.last_pool_stats == {}
    assert te.steps_total == 0 and te.static_chunks == 3
    # Chunks in descending prompt length: (11, 9), (6, 5), (4,).  Each
    # runs min(its longest response, max_new - 1) forwards.
    gl = dict(zip(LENS, _response_lens(ot, LENS, 1)))
    chunks = [(11, 9), (6, 5), (4,)]
    assert te.static_decode_steps == sum(
        min(max(gl[p] for p in c), max_new - 1) for c in chunks
    )


def test_static_min_new_tokens_masks_eos(weights, mesh):
    """An EOS that greedy decoding reaches at the second token: without
    min_new_tokens the response stops there; with min_new_tokens=4 both
    packages mask it for 4 steps and agree."""
    _, _, _, ot = _static_pair(weights, mesh, (6, 9), n=2, max_new=8, greedy=True)
    eos = int(ot.data["packed_input_ids"][6 + 1])  # prompt 0, token 1
    _, _, oj, ot = _static_pair(weights, mesh, (6, 9), n=2, max_new=8, eos=eos,
                                greedy=True)
    _assert_same(oj, ot)
    assert _response_lens(ot, (6, 9), 2)[0] == 2
    _, _, oj, ot = _static_pair(weights, mesh, (6, 9), n=2, max_new=8, eos=eos,
                                greedy=True, min_new_tokens=4)
    _assert_same(oj, ot)
    toks = ot.data["packed_input_ids"]
    off = 0
    for full, pl in zip([x for row in ot.seqlens["packed_input_ids"] for x in row],
                        (6, 6, 9, 9)):
        resp = toks[off + pl : off + full]
        assert len(resp) >= 4 and eos not in resp[:4].tolist()
        off += full


def test_static_path_equals_serving_plane(weights):
    """The port's two paths on one engine: greedy tokens identical,
    logprobs within 2e-4 (the JAX test's bound), no-EOS masks equal."""
    _, pt = weights
    _, ts = _samples(LENS)
    eng = GeneratorEngine(tiny_config(), pt, "cpu", eos_token_id=EOS, **KW)
    g = GenerationHyperparameters(n=1, max_new_tokens=8, greedy=True)
    out_static = eng.generate(ts, MicroBatchSpec(), g, inflight=False)
    assert eng.decode_compiles == 0
    out_inflight = eng.generate(ts, MicroBatchSpec(), g, inflight=True)
    assert eng.decode_compiles == 1
    assert out_inflight.ids == out_static.ids
    np.testing.assert_array_equal(
        out_inflight.data["packed_input_ids"], out_static.data["packed_input_ids"]
    )
    np.testing.assert_allclose(
        out_inflight.data["packed_logprobs"], out_static.data["packed_logprobs"],
        rtol=2e-4, atol=2e-4,
    )
    np.testing.assert_array_equal(
        out_inflight.data["seq_no_eos_mask"], out_static.data["seq_no_eos_mask"]
    )


class _Routed(Exception):
    pass


def _record_path(eng, static_name, inflight_name):
    """Replace the engine's two path entries with recorders that stop the
    call: the route is what is under test, not the generation."""
    taken = []

    def rec(name):
        def fn(*a, **k):
            taken.append(name)
            raise _Routed

        return fn

    setattr(eng, static_name, rec("static"))
    setattr(eng, inflight_name, rec("inflight"))
    return taken


# (request lengths, n, inflight argument, generation overrides,
#  static_path_max_new on both engines)
ROUTES = {
    "requests_over_batch": ((5, 7), 2, None, {}, None),
    "requests_fit_batch": ((5, 7), 1, None, {}, None),
    "max_new_over_static_budget": ((5,), 1, None, dict(max_new_tokens=6), 4),
    "max_new_at_static_budget": ((5,), 1, None, dict(max_new_tokens=6), 6),
    "stop_sequences": ((5,), 1, False, dict(stop=((1, 2),)), None),
    "explicit_static_over_batch": ((5, 7, 9), 1, False, {}, None),
    "explicit_inflight": ((5,), 1, True, {}, None),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_path_choice_matches_jax(weights, mesh, case):
    lens, n, inflight, gover, budget = ROUTES[case]
    pj, pt = weights
    js, ts = _samples(lens)
    je = JEngine(jtiny(), pj, mesh, eos_token_id=EOS, kv_paged=True, **KW)
    te = GeneratorEngine(tiny_config(), pt, "cpu", eos_token_id=EOS, **KW)
    if budget is not None:
        je.static_path_max_new = te.static_path_max_new = budget
    j_taken = _record_path(je, "_generate_chunk", "_generate_inflight")
    t_taken = _record_path(te, "_generate_chunk", "_generate_inflight_serving")
    g = dict(dict(n=n, max_new_tokens=4, greedy=True), **gover)
    with pytest.raises(_Routed):
        je.generate(js, JSpec(), JGen(**g), inflight=inflight)
    with pytest.raises(_Routed):
        te.generate(ts, MicroBatchSpec(), GenerationHyperparameters(**g),
                    inflight=inflight)
    assert t_taken == j_taken[:1] and len(t_taken) == 1
    want = {"requests_fit_batch": "static", "max_new_at_static_budget": "static",
            "explicit_static_over_batch": "static"}.get(case, "inflight")
    assert t_taken == [want]


def test_spec_decoding_still_raises_on_either_path(weights, mesh):
    """JAX sends spec decoding to its inflight path whatever `inflight`
    asks; the port, which raised here before it had spec decoding, now
    does the same, with the JAX engine's greedy tokens."""
    pj, pt = weights
    js, ts = _samples((5, 9))
    g = dict(n=1, max_new_tokens=6, greedy=True, spec_decode_k=2)
    je = JEngine(jtiny(), pj, mesh, eos_token_id=EOS, kv_paged=True, **KW)
    j_taken = _record_path(je, "_generate_chunk", "_generate_inflight")
    with pytest.raises(_Routed):
        je.generate(js, JSpec(), JGen(**g), inflight=False)
    assert j_taken == ["inflight"]
    for inflight in (None, False, True):
        te = GeneratorEngine(tiny_config(), pt, "cpu", eos_token_id=EOS, **KW)
        t_taken = _record_path(te, "_generate_chunk", "_generate_inflight")
        with pytest.raises(_Routed):
            te.generate(ts, MicroBatchSpec(), GenerationHyperparameters(**g),
                        inflight=inflight)
        assert t_taken == ["inflight"]
    je = JEngine(jtiny(), pj, mesh, eos_token_id=EOS, kv_paged=True, **KW)
    te = GeneratorEngine(tiny_config(), pt, "cpu", eos_token_id=EOS, **KW)
    _assert_same(je.generate(js, JSpec(), JGen(**g), inflight=False),
                 te.generate(ts, MicroBatchSpec(), GenerationHyperparameters(**g),
                             inflight=False))


def test_static_sampling_is_seeded_and_well_formed(weights):
    _, pt = weights
    _, ts = _samples((7, 12))
    eng = GeneratorEngine(tiny_config(), pt, "cpu", eos_token_id=EOS, **KW)
    g = GenerationHyperparameters(n=3, max_new_tokens=10, temperature=0.9, top_p=0.95)
    a = eng.generate(ts, MicroBatchSpec(), g, seed=5, inflight=False)
    b = eng.generate(ts, MicroBatchSpec(), g, seed=5, inflight=False)
    c = eng.generate(ts, MicroBatchSpec(), g, seed=6, inflight=False)
    np.testing.assert_array_equal(a.data["packed_input_ids"], b.data["packed_input_ids"])
    np.testing.assert_array_equal(a.data["packed_logprobs"], b.data["packed_logprobs"])
    assert not np.array_equal(a.data["packed_input_ids"], c.data["packed_input_ids"])
    lp = a.data["packed_logprobs"]  # 0 on prompt positions
    assert np.isfinite(lp).all() and (lp <= 0).all()
    ids = a.data["packed_input_ids"]
    assert ids.min() >= 0 and ids.max() < 512
    assert all(len(row) == 3 for row in a.seqlens["packed_input_ids"])
    assert eng.decode_compiles == 0 and eng.static_chunks == 9  # 3 calls x 3 chunks
