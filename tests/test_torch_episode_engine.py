"""Agent episodes on the port's GeneratorEngine against the JAX engine on
the CPU (tiny_config, one set of weights through numpy, fp32, 8-token
pages, W=4, 2 slots: the shapes of tests/test_gen_server.py:391).  Each
case runs the same script of episode ops on both engines and requires
greedy tokens identical, logprobs within 5e-4, every other field of every
turn dict equal, and `episode_stats` and the chunk builds equal:

- start, extend and release, with the probe-derived stop pair of
  tests/test_gen_server.py:402 and with every even token a stop (the
  agents leg's convention, scripts/check_async.py:2667);
- the per-turn clamp to the token budget and the terminal zero-token
  budget turn;
- a re-admission after SlotGone that maps the published prefix;
- LRU eviction of three episodes on two slots;
- an interrupt mid-turn, new weights, then episode_resume (K3's replay);
- spec_decode_k=2 (the cursor parked one short of the transcript);
- an int8 page pool."""

import jax
import numpy as np
import pytest
import torch

from areal_tpu.api.model_api import GenerationHyperparameters as JGen
from areal_tpu.api.model_api import SlotGoneError as JSlotGone
from areal_tpu.base.topology import ParallelConfig, make_mesh
from areal_tpu.engines.generator import GeneratorEngine as JEngine
from areal_tpu.models import transformer as jtfm
from areal_tpu.models.config import tiny_config as jtiny
from areal_tpu_torch.api.model_api import GenerationHyperparameters
from areal_tpu_torch.api.model_api import SlotGoneError
from areal_tpu_torch.engines.generator import GeneratorEngine
from areal_tpu_torch.models.config import tiny_config
from areal_tpu_torch.models.weights import params_from_numpy

torch.set_num_threads(1)

LOGP_TOL = 5e-4
KW = dict(kv_paged=True, kv_page_size=8, prefill_chunk_tokens=4, max_decode_batch=2)
# EOS outside the vocab: greedy decoding never ends early, turns end on
# the stop sequences or the budgets.
EOS = jtiny().vocab_size + 7
EVEN_STOPS = tuple((t,) for t in range(0, jtiny().vocab_size, 2))


def _weights(seed):
    pj = jtfm.init_params(jtiny(), jax.random.PRNGKey(seed))
    return pj, params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")


@pytest.fixture(scope="module")
def weights():
    return _weights(11)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(ParallelConfig.from_str("d1"), jax.devices()[:1])


def _prompt(n, seed=3):
    rng = np.random.default_rng(seed)
    return [int(x) for x in rng.integers(8, jtiny().vocab_size, size=n)]


class _Side:
    """One package's engine and the names its script calls."""

    def __init__(self, engine, gen_cls, gone_cls):
        self.e, self.G, self.Gone = engine, gen_cls, gone_cls


def _pair(weights, mesh, **ekw):
    pj, pt = weights
    kw = dict(KW, **ekw)
    return (
        _Side(JEngine(jtiny(), pj, mesh, eos_token_id=EOS, **kw), JGen, JSlotGone),
        _Side(GeneratorEngine(tiny_config(), pt, "cpu", eos_token_id=EOS, **kw),
              GenerationHyperparameters, SlotGoneError),
    )


def _same_turns(tj, tt):
    assert len(tj) == len(tt)
    for a, b in zip(tj, tt):
        if a is None or b is None:
            assert a is None and b is None
            continue
        assert set(a) == set(b)
        if "tokens" not in a:
            assert a == b
            continue
        assert a["tokens"] == b["tokens"], (a, b)
        assert len(a["logprobs"]) == len(b["logprobs"])
        if a["logprobs"]:
            np.testing.assert_allclose(a["logprobs"], b["logprobs"], atol=LOGP_TOL)
        for k in set(a) - {"tokens", "logprobs"}:
            assert a[k] == b[k], (k, a, b)


def _run_both(weights, mesh, script, **ekw):
    sides = _pair(weights, mesh, **ekw)
    outs = [script(side) for side in sides]
    _same_turns(outs[0], outs[1])
    assert sides[0].e.episode_stats() == sides[1].e.episode_stats()
    assert sides[0].e.decode_compiles == sides[1].e.decode_compiles == 1
    return outs[1], sides


def test_probe_stop_lifecycle(weights, mesh):
    """tests/test_gen_server.py:428 on both engines: turn 0 ends on the
    probe's stop pair (kept in the turn), turn 1 prefills only the
    observation, the transcript adds up, release frees the slot."""
    prompt = _prompt(10, seed=7)
    jside, tside = _pair(weights, mesh)
    probe = tside.e.generate  # the serving plane's greedy continuation
    from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample

    sample = SequenceSample(
        keys={"packed_prompts"}, ids=["p"], seqlens={"packed_prompts": [[10]]},
        data={"packed_prompts": np.asarray(prompt, np.int32)},
    )
    out = probe(sample, MicroBatchSpec(),
                GenerationHyperparameters(max_new_tokens=8, greedy=True), inflight=True)
    toks = [int(t) for t in np.asarray(out.data["packed_input_ids"])[10:]]
    obs = [int(x) + 1 for x in prompt[:3]]

    def script(side):
        g = side.G(n=1, max_new_tokens=8, greedy=True, stop=(tuple(toks[2:4]),))
        t1 = side.e.episode_start("ep-h", prompt, g, token_budget=64)
        t2 = side.e.episode_extend("ep-h", obs)
        released = side.e.episode_release("ep-h")
        return [t1, t2, {"released": released, "again": side.e.episode_release("ep-h")}]

    outs = [script(s) for s in (jside, tside)]
    _same_turns(outs[0], outs[1])
    t1, t2, rel = outs[1]
    assert t1["stop_reason"] == "stop"
    assert t1["tokens"][-2:] == toks[2:4] and t1["tokens"] == toks[: len(t1["tokens"])]
    assert t2["prefill_tokens"] == len(obs)
    assert t2["transcript_len"] == len(prompt) + len(t1["tokens"]) + len(obs) + len(t2["tokens"])
    assert rel == {"released": True, "again": False}
    assert jside.e.episode_stats() == tside.e.episode_stats()


def test_even_stops_two_episodes(weights, mesh):
    """Two episodes interleaved on two slots, every even token a stop:
    each extend prefills exactly its observation on the parked slot, the
    other episode's slot riding the stream as a done row; a third start
    with episode a's transcript maps its published prefix."""
    prompt = _prompt(21)

    def script(side):
        g = side.G(n=1, max_new_tokens=8, greedy=True, stop=EVEN_STOPS)
        out = [side.e.episode_start("a", prompt, g, token_budget=96),
               side.e.episode_start("b", prompt[:13], g, token_budget=96)]
        out.append(side.e.episode_extend("a", [5, 9, 11]))
        out.append(side.e.episode_extend("b", [3]))
        out.append(side.e.episode_extend("a", [17, 19]))
        side.e.episode_release("a")
        out.append(side.e.episode_start("c", prompt + out[0]["tokens"], g, token_budget=96))
        return out

    out, (_, tside) = _run_both(weights, mesh, script)
    assert [t["stop_reason"] for t in out] == ["stop"] * 6
    assert [t["prefill_tokens"] for t in out[2:5]] == [3, 1, 2]
    assert out[5]["shared_prefix_tokens"] == 24  # 3 full pages of a's transcript
    st = tside.e.episode_stats()
    assert (st["started"], st["prefix_hits"], st["active"]) == (3, 1, 2)


def test_budget_clamp_and_terminal_turn(weights, mesh):
    """A 24-token budget: the second turn's length is clamped to what the
    budget leaves ("budget"), and an observation that cannot fit gives a
    terminal zero-token turn with no admission."""
    prompt = _prompt(10)

    def script(side):
        g = side.G(n=1, max_new_tokens=8, greedy=True)
        out = [side.e.episode_start("x", prompt, g, token_budget=24)]
        out.append(side.e.episode_extend("x", [1, 2, 3]))
        out.append(side.e.episode_extend("x", [4, 5]))
        return out

    out, _ = _run_both(weights, mesh, script)
    assert [t["stop_reason"] for t in out] == ["length", "budget", "budget"]
    assert len(out[1]["tokens"]) == 24 - (10 + 8 + 3)
    assert out[2]["tokens"] == [] and out[2]["prefill_tokens"] == 0
    assert out[2]["transcript_len"] == out[1]["transcript_len"]


def test_slot_gone_readmission_hits_prefix(weights, mesh):
    """Release, then extend: the typed SlotGoneError in both packages;
    the re-admission of the full transcript maps its published pages and
    prefills only the tail."""
    prompt = _prompt(19)

    def script(side):
        g = side.G(n=1, max_new_tokens=8, greedy=True, stop=EVEN_STOPS)
        t0 = side.e.episode_start("r", prompt, g, token_budget=96)
        t1 = side.e.episode_extend("r", [6, 7])
        side.e.episode_release("r")
        with pytest.raises(side.Gone) as ei:
            side.e.episode_extend("r", [8])
        assert ei.value.episode_id == "r" and ei.value.reason == "slot reclaimed"
        transcript = prompt + t0["tokens"] + [6, 7] + t1["tokens"] + [8]
        t2 = side.e.episode_start("r", transcript, g, token_budget=96)
        return [t0, t1, t2, {"transcript": len(transcript)}]

    out, _ = _run_both(weights, mesh, script)
    t2, n = out[2], out[3]["transcript"]
    assert t2["shared_prefix_tokens"] > 0
    assert t2["prefill_tokens"] == n - t2["shared_prefix_tokens"]


def test_lru_eviction_three_episodes_on_two_slots(weights, mesh):
    """A third episode on two slots evicts the least recently admitted
    parked one, whose next extend is SlotGone; touching b first makes a
    the victim."""
    prompt = _prompt(12)

    def script(side):
        g = side.G(n=1, max_new_tokens=6, greedy=True, stop=EVEN_STOPS)
        out = [side.e.episode_start("a", prompt, g, token_budget=64),
               side.e.episode_start("b", prompt[:9], g, token_budget=64)]
        out.append(side.e.episode_extend("b", [3, 5]))
        out.append(side.e.episode_start("c", prompt[:7], g, token_budget=64))
        with pytest.raises(side.Gone):
            side.e.episode_extend("a", [9])
        out.append(side.e.episode_extend("b", [11]))
        out.append(side.e.episode_extend("c", [13]))
        return out

    out, (_, tside) = _run_both(weights, mesh, script)
    assert out[3]["slot"] == out[0]["slot"]  # c took a's slot
    st = tside.e.episode_stats()
    assert (st["evicted"], st["active"], st["started"]) == (1, 2, 3)


def _interrupt_after(side, n_chunks):
    """Make the engine's serving chunk raise the interrupt once it has
    run `n_chunks` chunks (the JAX engine asks for its chunk every turn,
    the port once a session: both get the wrapped function)."""
    real = side.e._get_serving_chunk_fn
    count = [0]

    def getter(*a, **k):
        fn = real(*a, **k)

        def run(*fa, **fk):
            out = fn(*fa, **fk)
            count[0] += 1
            if count[0] == n_chunks:
                side.e.interrupt()
            return out

        return run

    side.e._get_serving_chunk_fn = getter


@pytest.mark.parametrize("ekw", [{}, dict(kv_cache_dtype="int8")], ids=["bf16pool", "int8"])
def test_interrupt_mid_turn_new_weights_resume(weights, mesh, ekw):
    """A push inside turn 1: the turn parks (None), extend refuses while
    parked, the weights swap, episode_resume replays the slot's last
    chunk tail (resume_replays 1) and finishes the turn under the new
    weights; the next turn runs on after it."""
    prompt = _prompt(21)
    new = _weights(29)

    def script(side, new_params):
        g = side.G(n=1, max_new_tokens=16, greedy=True)
        _interrupt_after(side, 3)  # turn 0 runs 2 chunks: park after turn 1's first
        out = [side.e.episode_start("m", prompt, g, token_budget=128)]
        out.append(side.e.episode_extend("m", [4, 6, 8]))
        with pytest.raises(RuntimeError, match="parked mid-turn"):
            side.e.episode_extend("m", [1])
        out.append({"stats": side.e.episode_stats()})
        side.e.set_params(new_params)
        side.e.clear_interrupt()
        out.append(side.e.episode_resume("m"))
        out.append(side.e.episode_extend("m", [10]))
        return out

    jside, tside = _pair(weights, mesh, **ekw)
    oj = script(jside, new[0])
    ot = script(tside, new[1])
    _same_turns(oj, ot)
    assert ot[1] is None and ot[2]["stats"]["parked_mid_turn"] == 1
    assert tside.e.resume_replays == jside.e.resume_replays == 1
    assert ot[3]["transcript_len"] == 21 + 16 + 3 + 16
    assert jside.e.episode_stats() == tside.e.episode_stats()


def test_spec_decode_k2(weights, mesh):
    """spec_decode_k=2: each turn's last kept token may still be pending,
    so the cursor parks one short and the next admission forwards it with
    the observation (prefill_tokens = len(obs) + 1)."""
    prompt = _prompt(21)

    def script(side):
        g = side.G(n=1, max_new_tokens=8, greedy=True, stop=EVEN_STOPS, spec_decode_k=2)
        out = [side.e.episode_start("s", prompt, g, token_budget=96)]
        out.append(side.e.episode_extend("s", [5, 9]))
        out.append(side.e.episode_extend("s", [7]))
        return out

    out, _ = _run_both(weights, mesh, script)
    assert [t["prefill_tokens"] for t in out[1:]] == [3, 2]


def test_int8_pool(weights, mesh):
    """The lifecycle over an int8 page pool (codes and scales written by
    the serving chunk, read by the next turns)."""
    prompt = _prompt(21)

    def script(side):
        g = side.G(n=1, max_new_tokens=8, greedy=True, stop=EVEN_STOPS)
        out = [side.e.episode_start("q", prompt, g, token_budget=96),
               side.e.episode_start("p", prompt[:11], g, token_budget=96)]
        out.append(side.e.episode_extend("q", [5, 9, 11]))
        out.append(side.e.episode_extend("p", [2]))
        return out

    _run_both(weights, mesh, script, kv_cache_dtype="int8")


def test_episodes_need_the_serving_plane(weights):
    """The dense window and the two-program path refuse episodes, as in
    the JAX package."""
    for kw in (dict(kv_paged=False), dict(prefill_chunk_tokens=0)):
        eng = GeneratorEngine(tiny_config(), weights[1], "cpu", eos_token_id=EOS,
                              **dict(KW, **kw))
        with pytest.raises(RuntimeError, match="serving plane"):
            eng.episode_start("z", [1, 2, 3], GenerationHyperparameters(max_new_tokens=4))
