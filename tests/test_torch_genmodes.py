"""The generator's other inflight modes, the port's engine against the
JAX package's on the CPU (tiny_config, one set of weights, fp32, 2 slots
so that rows retire and new ones are admitted):

- the dense window (kv_paged=False), plain and with an int8 cache
  (twins of tests/test_generator.py:150, :316 and :348): greedy tokens
  equal, logprobs within 5e-4, and the engine counters — prefill
  dispatches, decode-chunk builds, decode steps and cache copy bytes —
  equal, through a window that grows;
- speculative decoding on the dense window, K in {1, 3}, fp32 and int8
  (tests/test_spec_decode.py:225, :340 and :380,
  tests/test_generator.py:232): equal to the JAX engine and, greedy, to
  plain greedy decoding; sampled outputs carry the model's logprobs;
- the two-program paged path (prefill_chunk_tokens=0), plain and int8
  (tests/test_paged_kv.py:135, :139 and :474), and a park and resume on
  it;
- spec on the serving plane (tests/test_paged_kv.py:143, :149 and
  :575), and the ValueError for spec over the two-program path (:646)."""

import jax
import numpy as np
import pytest
import torch

from areal_tpu.api.data_api import MicroBatchSpec as JSpec
from areal_tpu.api.model_api import GenerationHyperparameters as JGen
from areal_tpu.base.topology import ParallelConfig, make_mesh
from areal_tpu.engines.generator import GeneratorEngine as JEngine
from areal_tpu.models import transformer as jtfm
from areal_tpu.models.config import tiny_config as jtiny
from areal_tpu_torch.api.data_api import MicroBatchSpec
from areal_tpu_torch.api.model_api import GenerationHyperparameters
from areal_tpu_torch.engines.generator import GeneratorEngine
from areal_tpu_torch.models import transformer as ttfm
from areal_tpu_torch.models.config import tiny_config
from tests.test_torch_generator import EOS, LENS, _assert_same, _samples

torch.set_num_threads(1)

LOGP_TOL = 5e-4
DENSE = dict(kv_paged=False)
PAGED2 = dict(kv_paged=True, kv_page_size=8, prefill_chunk_tokens=0)
SERVING = dict(kv_paged=True, kv_page_size=8, prefill_chunk_tokens=4)


@pytest.fixture(scope="module")
def weights():
    from areal_tpu_torch.models.weights import params_from_numpy

    pj = jtfm.init_params(jtiny(), jax.random.PRNGKey(11))
    return pj, params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(ParallelConfig.from_str("d1"), jax.devices()[:1])


def _count_jax_steps(je):
    """Wrap the JAX engine's decode-chunk getters so each chunk adds its
    step count (the getter's step argument) to je.steps_run."""
    je.steps_run = 0
    for name, arg in (("_get_inflight_decode_fn", 2), ("_get_spec_decode_fn", 2),
                      ("_get_paged_decode_fn", 3), ("_get_serving_chunk_fn", 3)):
        real = getattr(je, name)

        def getter(*a, _real=real, _arg=arg, **k):
            fn = _real(*a, **k)

            def run(*fa, **fk):
                je.steps_run += a[_arg]
                return fn(*fa, **fk)

            return run

        setattr(je, name, getter)


def _pair(weights, mesh, lens, g, ekw, n_slots=2, seed=42):
    pj, pt = weights
    js, ts = _samples(lens, seed)
    je = JEngine(jtiny(), pj, mesh, eos_token_id=EOS, max_decode_batch=n_slots, **ekw)
    te = GeneratorEngine(tiny_config(), pt, "cpu", eos_token_id=EOS,
                         max_decode_batch=n_slots, **ekw)
    _count_jax_steps(je)
    oj = je.generate(js, JSpec(), JGen(**g), inflight=True)
    ot = te.generate(ts, MicroBatchSpec(), GenerationHyperparameters(**g), inflight=True)
    return je, te, oj, ot


def _assert_counters(je, te):
    for c in ("prefill_dispatches", "decode_compiles", "cache_copy_bytes"):
        assert getattr(te, c) == getattr(je, c), c
    if hasattr(je, "steps_run"):
        assert te.steps_total == je.steps_run


MODES = {
    "dense": (DENSE, {}),
    "dense_int8": (dict(DENSE, kv_cache_dtype="int8"), {}),
    "dense_spec_k1": (DENSE, dict(spec_decode_k=1, spec_ngram=2)),
    "dense_spec_k3": (DENSE, dict(spec_decode_k=3, spec_ngram=2)),
    "dense_spec_k3_int8": (dict(DENSE, kv_cache_dtype="int8"), dict(spec_decode_k=3)),
    "paged2": (PAGED2, {}),
    "paged2_int8": (dict(PAGED2, kv_cache_dtype="int8"), {}),
    "serving_spec_k2": (SERVING, dict(spec_decode_k=2)),
    "serving_spec_k2_int8": (dict(SERVING, kv_cache_dtype="int8"), dict(spec_decode_k=2)),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mode_matches_jax_engine(weights, mesh, mode):
    """5 requests through 2 slots, greedy: the JAX engine's tokens, its
    logprobs within 5e-4 and its counters."""
    ekw, gkw = MODES[mode]
    je, te, oj, ot = _pair(weights, mesh, LENS,
                           dict(n=1, max_new_tokens=10, greedy=True, **gkw), ekw)
    _assert_same(oj, ot, atol=LOGP_TOL)
    _assert_counters(je, te)
    if mode.startswith("serving"):
        for c in ("lanes_dispatched", "lanes_live", "lanes_slack", "serving_lane_budget"):
            assert getattr(te, c) == getattr(je, c), c
        assert te.dead_live_lanes == 0 and te.prefill_dispatches == 0
    else:
        assert te.prefill_dispatches == 3  # 2 + 2 + 1 admissions


@pytest.mark.parametrize("ekw,gkw", [
    (DENSE, {}), (dict(DENSE, kv_cache_dtype="int8"), {}),
    (DENSE, dict(spec_decode_k=2, spec_ngram=1)),
], ids=["dense", "dense_int8", "dense_spec"])
def test_dense_window_grows_like_jax(weights, mesh, ekw, gkw):
    """Rows long enough that the window grows (256 -> 512) while the
    short row retires and a long one waits: the same tokens, and
    cache_copy_bytes and the per-bucket chunk builds equal the JAX
    engine's."""
    je, te, oj, ot = _pair(weights, mesh, (40, 100, 7),
                           dict(n=1, max_new_tokens=300, min_new_tokens=300,
                                greedy=True, **gkw), ekw)
    _assert_same(oj, ot, atol=LOGP_TOL)
    _assert_counters(je, te)
    assert te.cache_copy_bytes > 0 and te.decode_compiles == 2


@pytest.mark.parametrize("ekw", [DENSE, PAGED2], ids=["dense", "paged2"])
def test_inflight_matches_static_greedy(weights, ekw):
    """Twin of tests/test_generator.py:150 on the port's dense window and
    two-program path: mixed lengths, more requests than slots, greedy
    tokens equal the static path's and logprobs within 2e-4."""
    _, pt = weights
    _, ts = _samples(LENS)
    eng = GeneratorEngine(tiny_config(), pt, "cpu", eos_token_id=EOS, max_decode_batch=2,
                          **ekw)
    g = GenerationHyperparameters(n=1, max_new_tokens=8, greedy=True)
    st = eng.generate(ts, MicroBatchSpec(), g, inflight=False)
    inf = eng.generate(ts, MicroBatchSpec(), g, inflight=True)
    np.testing.assert_array_equal(inf.data["packed_input_ids"], st.data["packed_input_ids"])
    np.testing.assert_allclose(inf.data["packed_logprobs"], st.data["packed_logprobs"],
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(inf.data["seq_no_eos_mask"], st.data["seq_no_eos_mask"])


def test_int8_agrees_with_full_precision(weights):
    """Twin of tests/test_generator.py:316 on the dense window: int8 is
    lossy, so greedy tokens agree with full precision on >= 0.85 of the
    positions, and the outputs are well formed."""
    _, pt = weights
    _, ts = _samples(LENS)
    g = GenerationHyperparameters(n=1, max_new_tokens=8, greedy=True)
    outs = [
        GeneratorEngine(tiny_config(), pt, "cpu", eos_token_id=EOS, max_decode_batch=2,
                        kv_cache_dtype=dt, **DENSE).generate(ts, MicroBatchSpec(), g,
                                                            inflight=True)
        for dt in ("auto", "int8")
    ]
    a, b = (o.data["packed_input_ids"] for o in outs)
    assert a.shape == b.shape and float((a == b).mean()) >= 0.85
    assert np.isfinite(outs[1].data["packed_logprobs"]).all()


def test_int8_serving_equals_dense_int8(weights):
    """The exact int8 contract (tests/test_paged_kv.py:602) in the port:
    every read sees dequant(quant(fresh)), so the serving plane's chunked
    admission, the dense window's one-shot prefill and the two-program
    path give the same greedy tokens."""
    _, pt = weights
    _, ts = _samples(LENS)
    g = GenerationHyperparameters(n=1, max_new_tokens=8, greedy=True)
    outs = [
        GeneratorEngine(tiny_config(), pt, "cpu", eos_token_id=EOS, max_decode_batch=2,
                        kv_cache_dtype="int8", **kw).generate(ts, MicroBatchSpec(), g,
                                                              inflight=True)
        for kw in (DENSE, SERVING, PAGED2)
    ]
    for o in outs[1:]:
        np.testing.assert_array_equal(o.data["packed_input_ids"],
                                      outs[0].data["packed_input_ids"])
        np.testing.assert_allclose(o.data["packed_logprobs"], outs[0].data["packed_logprobs"],
                                   atol=LOGP_TOL, rtol=0)


@pytest.mark.parametrize("ekw", [DENSE, SERVING], ids=["dense", "serving"])
@pytest.mark.parametrize("k", [1, 3])
def test_greedy_spec_matches_plain(weights, ekw, k):
    """Twin of tests/test_spec_decode.py:225: greedy speculation is the
    argmax chain whatever the drafts, so it gives plain greedy decoding's
    tokens (6 requests, 4 slots)."""
    _, pt = weights
    _, ts = _samples((6, 11, 4, 9, 13, 5), seed=0)
    eng = GeneratorEngine(tiny_config(), pt, "cpu", eos_token_id=EOS, max_decode_batch=4,
                          **ekw)
    g = GenerationHyperparameters(n=1, max_new_tokens=12, greedy=True)
    plain = eng.generate(ts, MicroBatchSpec(), g, inflight=True)
    spec = eng.generate(ts, MicroBatchSpec(), g.new(spec_decode_k=k, spec_ngram=2))
    assert spec.seqlens["packed_input_ids"] == plain.seqlens["packed_input_ids"]
    np.testing.assert_array_equal(spec.data["packed_input_ids"],
                                  plain.data["packed_input_ids"])
    np.testing.assert_allclose(spec.data["packed_logprobs"], plain.data["packed_logprobs"],
                               rtol=LOGP_TOL, atol=LOGP_TOL)


@pytest.mark.parametrize("ekw", [DENSE, SERVING], ids=["dense", "serving"])
def test_spec_budget_smaller_than_draft_window(weights, mesh, ekw):
    """Twin of tests/test_spec_decode.py:340: max_new_tokens < K+1, the
    host drains the overshoot, and the JAX engine's tokens come out."""
    je, te, oj, ot = _pair(weights, mesh, (6, 9),
                           dict(n=1, max_new_tokens=2, greedy=True, spec_decode_k=4,
                                spec_ngram=2), ekw, n_slots=4, seed=2)
    _assert_same(oj, ot, atol=LOGP_TOL)
    assert all(len(r) == 1 for r in ot.seqlens["packed_input_ids"])


def test_spec_admissions_are_batched(weights, mesh):
    """Twin of tests/test_generator.py:232: on the serving plane spec rows
    are ragged lanes of the one chunk (no standalone prefill, one build);
    on the dense window each refill is one batched prefill."""
    g = dict(n=1, max_new_tokens=8, min_new_tokens=8, greedy=True, spec_decode_k=2)
    je, te, oj, ot = _pair(weights, mesh, (6,) * 8, g, SERVING, n_slots=4)
    assert te.prefill_dispatches == je.prefill_dispatches == 0
    assert te.decode_compiles == je.decode_compiles == 1
    _assert_same(oj, ot, atol=LOGP_TOL)
    je, te, oj, ot = _pair(weights, mesh, (6,) * 8, g, DENSE, n_slots=4)
    assert te.prefill_dispatches == je.prefill_dispatches >= 2
    _assert_same(oj, ot, atol=LOGP_TOL)


def test_two_program_admissions_are_batched(weights, mesh):
    """Twin of tests/test_generator.py:204's legacy half: 12 uniform
    requests through 4 slots retire in lockstep, one prefill per refill,
    ceil(12 / 4) = 3, and the serving plane runs none."""
    g = dict(n=1, max_new_tokens=8, min_new_tokens=8, greedy=True)
    je, te, oj, ot = _pair(weights, mesh, (6,) * 12, g, PAGED2, n_slots=4)
    assert te.prefill_dispatches == je.prefill_dispatches == 3
    _assert_same(oj, ot, atol=LOGP_TOL)
    _assert_counters(je, te)


def test_spec_without_serving_plane_is_rejected(weights, mesh):
    """Twin of tests/test_paged_kv.py:646: spec decoding over the paged
    pool needs the serving plane; with prefill_chunk_tokens=0 both
    engines raise ValueError rather than fall back."""
    pj, pt = weights
    js, ts = _samples((5,))
    g = dict(n=1, max_new_tokens=4, greedy=True, spec_decode_k=2)
    je = JEngine(jtiny(), pj, mesh, eos_token_id=EOS, max_decode_batch=2, **PAGED2)
    te = GeneratorEngine(tiny_config(), pt, "cpu", eos_token_id=EOS, max_decode_batch=2,
                         **PAGED2)
    with pytest.raises(ValueError, match="serving plane"):
        je.generate(js, JSpec(), JGen(**g))
    with pytest.raises(ValueError, match="serving plane"):
        te.generate(ts, MicroBatchSpec(), GenerationHyperparameters(**g))


@pytest.mark.parametrize("ekw", [DENSE, SERVING], ids=["dense", "serving"])
def test_sampled_spec_logprobs_are_the_models(weights, ekw):
    """Sampled spec decoding (n=2, refills, mixed lengths; the slow JAX
    case tests/test_spec_decode.py:263 at a smaller size): every response
    token's behaviour logprob is the model's log p(token | prefix) from a
    full forward, within 5e-3, and the outputs are seeded."""
    _, pt = weights
    _, ts = _samples((5, 9, 6, 12), seed=3)
    eng = GeneratorEngine(tiny_config(), pt, "cpu", eos_token_id=EOS, max_decode_batch=3,
                          **ekw)
    g = GenerationHyperparameters(n=2, max_new_tokens=10, temperature=1.0,
                                  spec_decode_k=2, spec_ngram=2)
    out = eng.generate(ts, MicroBatchSpec(), g, seed=5)
    again = eng.generate(ts, MicroBatchSpec(), g, seed=5)
    np.testing.assert_array_equal(out.data["packed_input_ids"],
                                  again.data["packed_input_ids"])
    toks, lps = out.data["packed_input_ids"], out.data["packed_logprobs"]
    plens = [l for row in ts.seqlens["packed_prompts"] for l in row for _ in range(2)]
    t_off = lp_off = 0
    worst = 0.0
    for L, pl in zip([l for row in out.seqlens["packed_input_ids"] for l in row], plens):
        seq = torch.from_numpy(toks[t_off:t_off + L].astype(np.int64))[None]
        logq = torch.log_softmax(ttfm.forward(pt, tiny_config(), seq, torch.ones_like(seq))[0],
                                 -1)
        for j in range(pl, L):
            worst = max(worst, abs(float(logq[j - 1, seq[0, j]]) - lps[lp_off + j - 1]))
        t_off += L
        lp_off += L - 1
    assert worst < 5e-3, worst


def test_two_program_path_parks_and_resumes(weights):
    """interrupt() parks the two-program loop at a chunk boundary; the
    resume replays each live row's last chunk through the pool (K3's
    chunk form) and finishes with the uninterrupted run's greedy tokens."""
    _, pt = weights
    _, ts = _samples((17, 9), seed=1)

    def build():
        return GeneratorEngine(tiny_config(), pt, "cpu", eos_token_id=tiny_config().vocab_size + 7,
                               max_decode_batch=2, **PAGED2)

    g = GenerationHyperparameters(n=2, max_new_tokens=40, greedy=True)
    ref = build().generate(ts, MicroBatchSpec(), g, inflight=True)
    eng = build()
    real_get = eng._get_paged_decode_fn
    calls = {"n": 0}

    def hooked(*a, **k):
        fn = real_get(*a, **k)

        def run(*fa, **fk):
            calls["n"] += 1
            if calls["n"] == 1:
                eng.interrupt()  # parks after this chunk, with both rows live
            return fn(*fa, **fk)

        return run

    eng._get_paged_decode_fn = hooked
    assert eng.generate(ts, MicroBatchSpec(), g, inflight=True) is None and eng.interrupted
    eng.clear_interrupt()
    out = eng.resume_generate()
    assert out is not None and eng.resume_replays == 1
    np.testing.assert_array_equal(out.data["packed_input_ids"], ref.data["packed_input_ids"])
    np.testing.assert_allclose(out.data["packed_logprobs"], ref.data["packed_logprobs"],
                               atol=LOGP_TOL, rtol=0)
