"""The port's episode module (areal_tpu_torch/system/episode.py) against
the JAX package's, on the CPU.

The host-side cases of tests/test_episode.py run against both packages,
each as a parametrised case of one test: the records and
`to_trajectory`, the calculator, the tool executor (registration,
timeouts, fault injection, the sandboxed python_exec) and the controller
over a scripted client.  Then `EpisodeController` drives calculator
episodes over `EngineEpisodeClient` and `ServerEpisodeClient` (HTTP) on
both packages' engines at tiny size, and the four runs give equal
episodes: tokens identical, logprobs within 5e-4, every turn's role,
stop reason, tool and outcome equal."""

import time
import types

import jax
import numpy as np
import pytest
import torch

import areal_tpu.api.model_api as j_api
import areal_tpu.base.faults as j_faults
import areal_tpu.system.episode as j_episode
import areal_tpu_torch.api.model_api as t_api
import areal_tpu_torch.base.faults as t_faults
import areal_tpu_torch.system.episode as t_episode

torch.set_num_threads(1)

LOGP_TOL = 5e-4


def _ns(episode, api, faults):
    return types.SimpleNamespace(
        Episode=episode.Episode, Turn=episode.Turn, ToolCall=episode.ToolCall,
        ToolError=episode.ToolError, ToolExecutor=episode.ToolExecutor,
        EpisodeController=episode.EpisodeController, SlotGoneError=api.SlotGoneError,
        FaultInjector=faults.FaultInjector, module=episode,
    )


PKGS = {"jax": _ns(j_episode, j_api, j_faults), "torch": _ns(t_episode, t_api, t_faults)}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------


def _episode(p):
    ep = p.Episode(episode_id="e0", prompt_ids=[1, 2, 3])
    ep.turns = [
        p.Turn(index=0, role="assistant", tokens=[4, 5], logprobs=[-0.1, -0.2],
               stop_reason="stop", version=3, version_start=3),
        p.Turn(index=1, role="tool", tokens=[6], tool_name="calculator", tool_ok=True,
               version=3),
        p.Turn(index=2, role="assistant", tokens=[7, 8, 9], logprobs=[-0.3, -0.4, -0.5],
               stop_reason="eos", version=5, version_start=4),
    ]
    ep.stop_reason, ep.status = "eos", "done"
    return ep


def test_records_transcript(pkg):
    ep = _episode(pkg)
    assert ep.transcript() == [1, 2, 3, 4, 5, 6, 7, 8, 9]
    assert ep.response_text_tokens() == [4, 5, 6, 7, 8, 9]
    assert ep.assistant_turns == 2


def test_records_to_trajectory(pkg):
    """One group with the turn spans; tool tokens carry zero logprobs;
    the versions span the episode; no_eos follows the last assistant
    turn."""
    traj = _episode(pkg).to_trajectory(qid="q7", birth_time=1.5)
    assert (traj.qid, traj.prompt_ids, traj.birth_time) == ("q7", [1, 2, 3], 1.5)
    assert traj.output_ids == [[4, 5, 6, 7, 8, 9]]
    assert traj.output_logprobs == [[-0.1, -0.2, 0.0, -0.3, -0.4, -0.5]]
    spans = traj.data["episode"]["turns"]
    assert [(s["role"], s["start"], s["len"]) for s in spans] == [
        ("assistant", 0, 2), ("tool", 2, 1), ("assistant", 3, 3)]
    assert (traj.version_start, traj.version_end) == (3, 5)
    assert traj.no_eos == [False]
    ep = _episode(pkg)
    ep.turns[-1].stop_reason = "length"
    assert ep.to_trajectory().no_eos == [True]


def test_trajectories_equal_across_packages():
    import dataclasses

    a = dataclasses.asdict(_episode(PKGS["jax"]).to_trajectory(qid="q"))
    b = dataclasses.asdict(_episode(PKGS["torch"]).to_trajectory(qid="q"))
    assert a == b


# ---------------------------------------------------------------------------
# tools
# ---------------------------------------------------------------------------


def test_calculator(pkg):
    tools = pkg.ToolExecutor(register_builtins=True)

    def run(expr):
        return tools.run(pkg.ToolCall("calculator", expr))

    assert [run(e) for e in ("2 * (3 + 4)", "-7 // 2", "2 ** 10", "10 / 4", "8 / 2")] == [
        "14", "-4", "1024", "2.5", "4"]
    for evil in ("__import__('os').system('true')", "open('/etc/passwd')", "(1).__class__"):
        with pytest.raises(pkg.ToolError) as ei:
            run(evil)
        assert ei.value.kind == "error"


def test_tool_executor_registry(pkg):
    tools = pkg.ToolExecutor(register_builtins=False)
    with pytest.raises(pkg.ToolError) as ei:
        tools.run(pkg.ToolCall("nope", ""))
    assert ei.value.kind == "unknown_tool"
    tools.register("echo", lambda a: f"<<{a}>>")
    assert tools.names() == ["echo"]
    assert tools.run(pkg.ToolCall("echo", "hi")) == "<<hi>>"


def test_tool_timeout(pkg):
    tools = pkg.ToolExecutor(register_builtins=False)
    tools.register("sleepy", lambda a: time.sleep(3), timeout_s=0.05)
    t0 = time.monotonic()
    with pytest.raises(pkg.ToolError) as ei:
        tools.run(pkg.ToolCall("sleepy", ""))
    assert ei.value.kind == "timeout"
    assert time.monotonic() - t0 < 2.5


def test_tool_fault_breaks_exactly_one_call(pkg):
    tools = pkg.ToolExecutor(
        faults=pkg.FaultInjector.parse("error@point=tool:flaky&times=1"),
        register_builtins=False,
    )
    tools.register("flaky", lambda a: "ok")
    with pytest.raises(pkg.ToolError) as ei:
        tools.run(pkg.ToolCall("flaky", ""))
    assert ei.value.kind == "fault"
    assert tools.run(pkg.ToolCall("flaky", "")) == "ok"


def test_python_exec(pkg):
    """The sandboxed tool runs a program (or, where the host refuses the
    jail, fails typed within its timeout, never hangs); a nonzero exit is
    a typed error."""
    tools = pkg.ToolExecutor(timeout_s=15.0)
    assert tools.run(pkg.ToolCall("python_exec", "print(6 * 7)")).strip() == "42"
    with pytest.raises(pkg.ToolError) as ei:
        tools.run(pkg.ToolCall("python_exec", "raise SystemExit(3)"))
    assert ei.value.kind == "error"


@pytest.mark.parametrize("spec,err", [
    ("boom@p=1", "unknown kind"), ("error@p=2", "out of"), ("error@x=1", "unknown param"),
    ("error@ms=5", "only applies to slow"), ("nan@p=1", "needs point"),
])
def test_fault_grammar_errors_match(spec, err):
    for mod in (j_faults, t_faults):
        with pytest.raises(ValueError, match=err):
            mod.parse_faults(spec)


def test_fault_specs_parse_equal():
    import dataclasses

    text = "slow@ms=50&p=0.5, error@point=tool:x&skip=2&times=1 hang@t=5s kill@t=200ms"
    a = [dataclasses.asdict(s) for s in j_faults.parse_faults(text)]
    b = [dataclasses.asdict(s) for s in t_faults.parse_faults(text)]
    assert a == b


# ---------------------------------------------------------------------------
# the controller over a scripted client
# ---------------------------------------------------------------------------


def _turn(tokens, stop_reason, version=0):
    return {"tokens": list(tokens), "logprobs": [-0.5] * len(tokens),
            "stop_reason": stop_reason, "version": version}


class FakeClient:
    """Scripted episode client: each start/extend pops the next reply (a
    turn dict, or an exception to raise)."""

    def __init__(self, replies):
        self.replies = list(replies)
        self._v = 0
        self.starts, self.extends, self.released = [], [], []

    def version(self):
        return self._v

    def _next(self):
        item = self.replies.pop(0)
        if isinstance(item, Exception):
            raise item
        self._v = item.get("version", self._v)
        return dict(item)

    def start(self, ep_id, prompt_ids):
        self.starts.append((ep_id, list(prompt_ids)))
        return self._next()

    def extend(self, ep_id, obs_ids):
        self.extends.append((ep_id, list(obs_ids)))
        return self._next()

    def release(self, ep_id):
        self.released.append(ep_id)


def _ctl(pkg, client, parse=None, encode=None, max_turns=4, tool="calculator"):
    tools = pkg.ToolExecutor(register_builtins=False)
    tools.register("calculator", lambda a: "5")
    return pkg.EpisodeController(
        client, tools, parse or (lambda toks: pkg.ToolCall(tool, "2+3")),
        encode or (lambda call, text, ok: [99]), max_turns=max_turns,
    )


def test_controller_two_turns_to_eos(pkg):
    client = FakeClient([_turn([10, 11], "stop", 1), _turn([12, 13], "eos", 1)])
    ep = _ctl(pkg, client).run_episode("e1", [1, 2])
    assert (ep.status, ep.stop_reason) == ("done", "eos")
    assert [t.role for t in ep.turns] == ["assistant", "tool", "assistant"]
    assert (ep.turns[1].tool_name, ep.turns[1].tool_ok) == ("calculator", True)
    assert client.extends == [("e1", [99])] and client.released == ["e1"]


def test_controller_terminal_conditions(pkg):
    """max_turns caps the loop; no tool call, length and budget end it."""
    client = FakeClient([_turn([10], "stop")])
    ep = _ctl(pkg, client, max_turns=1).run_episode("e2", [1])
    assert (ep.stop_reason, ep.assistant_turns, client.extends) == ("max_turns", 1, [])
    ep = _ctl(pkg, FakeClient([_turn([10], "stop")]), parse=lambda t: None).run_episode("e3", [1])
    assert ep.stop_reason == "no_tool_call"
    for reason in ("length", "budget"):
        client = FakeClient([_turn([10], reason)])
        assert _ctl(pkg, client).run_episode("e4", [1]).stop_reason == reason
        assert client.extends == []
    with pytest.raises(ValueError, match="max_turns"):
        _ctl(pkg, FakeClient([]), max_turns=0)


def test_controller_tool_failure_is_an_observation(pkg):
    seen = {}

    def encode(call, text, ok):
        seen["text"], seen["ok"] = text, ok
        return [77]

    client = FakeClient([_turn([10], "stop"), _turn([11], "eos")])
    ep = _ctl(pkg, client, encode=encode, tool="missing").run_episode("e5", [1])
    assert ep.stop_reason == "eos" and ep.turns[1].tool_ok is False
    assert seen["ok"] is False and "unknown_tool" in seen["text"]


def test_controller_slot_gone_readmits_transcript(pkg):
    client = FakeClient([_turn([10, 11], "stop"), pkg.SlotGoneError("e6", "evicted"),
                         _turn([12], "eos")])
    ep = _ctl(pkg, client).run_episode("e6", [1, 2])
    assert (ep.stop_reason, ep.slot_lost) == ("eos", 1)
    assert client.starts[-1] == ("e6", [1, 2, 10, 11, 99])


def test_controller_releases_when_the_client_fails(pkg):
    client = FakeClient([RuntimeError("transport died")])
    with pytest.raises(RuntimeError, match="transport died"):
        _ctl(pkg, client).run_episode("e7", [1])
    assert client.released == ["e7"]


# ---------------------------------------------------------------------------
# the controller over both engines, in process and over HTTP
# ---------------------------------------------------------------------------


def _parse_calc(pkg):
    def parse(toks):  # the agents leg's token-level convention
        a, b = (list(toks) * 2)[-2:]
        return pkg.ToolCall("calculator", f"{a % 9} + {b % 9}")

    return parse


def _encode_obs(call, text, ok):
    return [8 + (ord(c) % 16) for c in text][:6] or [8]


@pytest.fixture(scope="module")
def engines():
    from areal_tpu.base.topology import ParallelConfig, make_mesh
    from areal_tpu.engines.generator import GeneratorEngine as JEngine
    from areal_tpu.models import transformer as jtfm
    from areal_tpu.models.config import tiny_config as jtiny
    from areal_tpu_torch.engines.generator import GeneratorEngine
    from areal_tpu_torch.models.config import tiny_config
    from areal_tpu_torch.models.weights import params_from_numpy

    pj = jtfm.init_params(jtiny(), jax.random.PRNGKey(5))
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    mesh = make_mesh(ParallelConfig.from_str("d1"), jax.devices()[:1])
    kw = dict(kv_paged=True, kv_page_size=8, prefill_chunk_tokens=4, max_decode_batch=2,
              eos_token_id=jtiny().vocab_size + 7)
    return (lambda: JEngine(jtiny(), pj, mesh, **kw),
            lambda: GeneratorEngine(tiny_config(), pt, "cpu", **kw))


def _run_controller(pkg_name, transport, engines):
    """Three calculator episodes (max_turns 3) over one engine of the
    package, in process or through its HTTP server; the second episode
    shares the first's prompt, the third is longer than a page."""
    p = PKGS[pkg_name]
    engine = engines[0 if pkg_name == "jax" else 1]()
    G = (j_api if pkg_name == "jax" else t_api).GenerationHyperparameters
    vocab = 512
    g = G(n=1, max_new_tokens=8, greedy=True, stop=tuple((t,) for t in range(0, vocab, 2)))
    rng = np.random.default_rng(17)
    prompts = [[int(t) for t in rng.integers(8, vocab, size=n)] for n in (12, 12, 19)]
    server = None
    if transport == "engine":
        client = p.module.EngineEpisodeClient(engine, g, token_budget=96)
    else:
        if pkg_name == "jax":
            from areal_tpu.system.gen_server import GenerationServer

            server = GenerationServer(engine, max_wait_ms=2.0, zmq_port=None)
        else:
            from areal_tpu_torch.system.gen_server import GenerationServer

            server = GenerationServer(engine, max_wait_ms=2.0)
        api = (j_api if pkg_name == "jax" else t_api).LLMAPIClient(server.url)
        client = p.module.ServerEpisodeClient(api, g, token_budget=96)
    try:
        ctl = p.EpisodeController(client, p.ToolExecutor(timeout_s=10.0), _parse_calc(p),
                                  _encode_obs, max_turns=3)
        eps = [ctl.run_episode(f"calc-{i}", pr) for i, pr in enumerate(prompts)]
    finally:
        if server is not None:
            server.close()
    return eps, engine.episode_stats()


def test_controller_over_both_engines_and_transports(engines):
    runs = {(pk, tr): _run_controller(pk, tr, engines)
            for pk in ("jax", "torch") for tr in ("engine", "server")}
    ref_eps, ref_stats = runs[("jax", "engine")]
    assert all(ep.stop_reason == "max_turns" and ep.assistant_turns == 3 for ep in ref_eps)
    for key, (eps, stats) in runs.items():
        assert stats == ref_stats, key
        for a, b in zip(ref_eps, eps):
            assert (a.episode_id, a.stop_reason, a.slot_lost, a.status) == (
                b.episode_id, b.stop_reason, b.slot_lost, b.status), key
            assert len(a.turns) == len(b.turns)
            for ta, tb in zip(a.turns, b.turns):
                assert (ta.role, ta.tokens, ta.stop_reason, ta.tool_name, ta.tool_ok) == (
                    tb.role, tb.tokens, tb.stop_reason, tb.tool_name, tb.tool_ok), key
                assert len(ta.logprobs) == len(tb.logprobs)
                if ta.logprobs:
                    np.testing.assert_allclose(ta.logprobs, tb.logprobs, atol=LOGP_TOL)
