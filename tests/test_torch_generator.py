"""The port's serving plane against the JAX package's on the CPU, one set
of tiny_config weights: `GeneratorEngine(kv_paged=True, kv_page_size=8,
prefill_chunk_tokens=4, max_decode_batch=2)` with `inflight=True` on the
JAX side.  Greedy tokens are identical, behaviour logprobs agree within
1e-4, and the lane / page-sharing counters are equal (twins of the
serving-plane tests in tests/test_paged_kv.py)."""

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
    with pytest.raises(PagePoolExhausted):
        GeneratorEngine(tiny_config(), weights[1], "cpu", eos_token_id=EOS,
                        kv_pool_pages=2, **KW).generate(
            ts, MicroBatchSpec(), GenerationHyperparameters(max_new_tokens=4)
        )


def test_unported_paths_raise(weights):
    _, pt = weights
    _, ts = _samples((5,))
    eng = GeneratorEngine(tiny_config(), pt, "cpu", eos_token_id=EOS, **KW)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        eng.generate(ts, MicroBatchSpec(), GenerationHyperparameters(spec_decode_k=2))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        eng.episode_start()
    for bad in (dict(kv_paged=False), dict(prefill_chunk_tokens=0)):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            GeneratorEngine(tiny_config(), pt, "cpu", eos_token_id=EOS, **bad)


def test_default_device_is_the_card(weights):
    """device=None means CUDA: without a card the engine refuses to start
    rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        GeneratorEngine(tiny_config(), weights[1], eos_token_id=EOS)
