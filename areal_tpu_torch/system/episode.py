"""Agent-serving episodes: multi-turn tool use on persistent KV state
(port of areal_tpu/system/episode.py).

An episode is a conversation the serving side keeps hot: each assistant
turn decodes until it emits a tool-call stop sequence (or EOS, or a
budget), the slot parks at a chunk boundary with its KV pages held, the
tool's result is chunk-prefilled onto the SAME pages, and decoding goes
on, so turn N+1 forwards only the observation, never the transcript.

- ``Turn`` / ``Episode``: the state machine's records.  An episode
  flattens to ONE replay ``Trajectory`` (each turn stamped with its
  weight version, the turn spans in ``data``).
- ``ToolExecutor``: named tools (the AST-fenced calculator and the
  sandboxed ``python_exec`` built in) with per-tool timeouts and fault
  hooks (``AREAL_FAULTS="error@point=tool:calculator&times=1"``).
- ``EpisodeController``: start, parse the tool call out of the
  stop-terminated turn, run the tool, extend with the observation,
  repeat until a terminal turn or the turn budget.  A continuation on a
  reclaimed slot raises the typed ``SlotGoneError``; the controller
  re-admits the FULL conversation, which the transcript prefix cache
  turns into a tail prefill.

The controller is token-centric and drives any client with
``start/extend/release``: ``EngineEpisodeClient`` (an in-process
GeneratorEngine) or ``ServerEpisodeClient`` (an ``LLMAPIClient`` against
a GenerationServer).  Tool-call parsing and observation encoding are
injected: they belong to the model's chat template.

``RewardFabric`` grades asynchronously (a bounded thread pool over
the verifier registry, or a remote ``verify_batch`` client such as the
reward service's ``RemoteVerifier`` or the verifier fleet's
``VerifierPool``), so an episode's end never blocks on a sandboxed test
run.

Each assistant turn is an ``episode_turn`` span (`base/tracer.py`),
carrying the dispatcher's ``trace_id`` when there is one; the id also
rides to the server (its ``turn`` lineage stamps) and to the grader.
"""

import ast
import dataclasses
import logging
import threading
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Any, Callable, Dict, List, Optional, Sequence

from areal_tpu_torch.api.model_api import GenerationHyperparameters, SlotGoneError
from areal_tpu_torch.base import metrics, tracer
from areal_tpu_torch.base.faults import FaultError, FaultInjector
from areal_tpu_torch.interfaces.sandbox import run_sandboxed
from areal_tpu_torch.system.replay import Trajectory

logger = logging.getLogger("areal_tpu_torch.episode")

_reg = metrics.default_registry()
# Assistant turns completed, by how the turn ended — the fleet signal
# separating "agents are calling tools" (stop) from "agents are rambling
# into their budgets" (length/budget).
_M_TURNS = _reg.counter(
    "areal_episode_turns_total",
    "assistant turns completed, by stop reason",
    ("stop_reason",),
)
_M_ACTIVE = _reg.gauge(
    "areal_episode_active",
    "episodes currently running under a controller",
)
_M_TOOL_SECONDS = _reg.histogram(
    "areal_episode_tool_seconds",
    "tool execution latency, by tool",
    ("tool",),
)
_M_EPISODES = _reg.counter(
    "areal_episode_completed_total",
    "episodes finished, by terminal reason",
    ("reason",),
)
_M_TOOL_ERRORS = _reg.counter(
    "areal_episode_tool_errors_total",
    "tool executions that failed, by tool and error kind",
    ("tool", "kind"),
)


# ---------------------------------------------------------------------------
# state machine records
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Turn:
    """One step of an episode: either an assistant decode (``role ==
    "assistant"``, carries logprobs + stop_reason) or a tool observation
    (``role == "tool"``, carries the tool name/latency/outcome).  Each
    turn is stamped with the weight version that produced it so replay
    admission can reason about mid-episode weight pushes."""

    index: int
    role: str  # "assistant" | "tool"
    tokens: List[int]
    logprobs: List[float] = dataclasses.field(default_factory=list)
    stop_reason: str = ""  # assistant: stop | eos | length | budget
    tool_name: str = ""
    tool_ok: bool = True
    tool_latency_s: float = 0.0
    version: int = 0  # weight version when this turn finished
    version_start: int = 0  # weight version when this turn started


@dataclasses.dataclass
class Episode:
    """A full multi-turn conversation and its terminal outcome."""

    episode_id: str
    prompt_ids: List[int]
    turns: List[Turn] = dataclasses.field(default_factory=list)
    status: str = "running"  # running | done
    stop_reason: str = ""  # eos | length | budget | max_turns | no_tool_call
    slot_lost: int = 0  # times the controller re-admitted after SlotGone
    reward: Optional[float] = None

    @property
    def assistant_turns(self) -> int:
        return sum(1 for t in self.turns if t.role == "assistant")

    def transcript(self) -> List[int]:
        """The full token transcript: prompt plus every turn in order —
        exactly the sequence sitting on the serving slot's KV pages."""
        out = list(self.prompt_ids)
        for t in self.turns:
            out.extend(t.tokens)
        return out

    def response_text_tokens(self) -> List[int]:
        """Everything after the prompt (assistant + tool tokens)."""
        out: List[int] = []
        for t in self.turns:
            out.extend(t.tokens)
        return out

    def to_trajectory(self, qid: str = "", birth_time: float = 0.0
                      ) -> Trajectory:
        """Flatten to ONE replay trajectory (group size 1): the prompt
        plus the concatenated turns, with tool-observation tokens carrying
        zero logprobs (they were injected, not sampled — the trainer masks
        them via the per-turn spans in ``data``).  ``version_start`` is the
        version the FIRST assistant turn started under and ``version_end``
        the version the LAST finished under, so bounded-staleness admission
        sees the episode's true age even across mid-episode pushes."""
        toks: List[int] = []
        lps: List[float] = []
        spans: List[Dict[str, Any]] = []
        for t in self.turns:
            spans.append(
                {
                    "index": t.index,
                    "role": t.role,
                    "start": len(toks),
                    "len": len(t.tokens),
                    "stop_reason": t.stop_reason,
                    "tool_name": t.tool_name,
                    "tool_ok": t.tool_ok,
                    "version": t.version,
                }
            )
            toks.extend(t.tokens)
            lps.extend(
                t.logprobs if t.role == "assistant" and t.logprobs
                else [0.0] * len(t.tokens)
            )
        a_turns = [t for t in self.turns if t.role == "assistant"]
        v0 = a_turns[0].version_start if a_turns else 0
        v1 = a_turns[-1].version if a_turns else 0
        last_reason = a_turns[-1].stop_reason if a_turns else ""
        return Trajectory(
            qid=qid or self.episode_id,
            prompt_ids=list(self.prompt_ids),
            output_ids=[toks],
            output_logprobs=[lps],
            no_eos=[last_reason != "eos"],
            version_start=v0,
            version_end=v1,
            birth_time=birth_time,
            data={
                "episode": {
                    "episode_id": self.episode_id,
                    "stop_reason": self.stop_reason,
                    "turns": spans,
                    "slot_lost": self.slot_lost,
                    "reward": self.reward,
                }
            },
        )


# ---------------------------------------------------------------------------
# tool executor registry
# ---------------------------------------------------------------------------


class ToolError(RuntimeError):
    """A tool execution failed; ``kind`` is the counter label
    (timeout | fault | error | unknown_tool)."""

    def __init__(self, kind: str, detail: str = ""):
        super().__init__(f"tool failed ({kind}): {detail}")
        self.kind = kind
        self.detail = detail


@dataclasses.dataclass(frozen=True)
class ToolCall:
    """A parsed tool invocation: a registry name plus a raw argument
    string (the tool decides how to interpret it)."""

    name: str
    args: str = ""


@dataclasses.dataclass
class _ToolSpec:
    fn: Callable[[str], str]
    timeout_s: float


def _calculator(args: str) -> str:
    """Arithmetic on a literal expression — numbers and ``+ - * / // %
    **`` with parentheses, evaluated over a parsed AST so no name lookup
    or call can ever run (``eval`` never sees the string)."""
    allowed_binops = (
        ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv, ast.Mod,
        ast.Pow,
    )

    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant) and isinstance(
            node.value, (int, float)
        ):
            return node.value
        if isinstance(node, ast.UnaryOp) and isinstance(
            node.op, (ast.UAdd, ast.USub)
        ):
            v = ev(node.operand)
            return v if isinstance(node.op, ast.UAdd) else -v
        if isinstance(node, ast.BinOp) and isinstance(
            node.op, allowed_binops
        ):
            lhs, rhs = ev(node.left), ev(node.right)
            if isinstance(node.op, ast.Add):
                return lhs + rhs
            if isinstance(node.op, ast.Sub):
                return lhs - rhs
            if isinstance(node.op, ast.Mult):
                return lhs * rhs
            if isinstance(node.op, ast.Div):
                return lhs / rhs
            if isinstance(node.op, ast.FloorDiv):
                return lhs // rhs
            if isinstance(node.op, ast.Mod):
                return lhs % rhs
            return lhs ** rhs
        raise ValueError(f"disallowed expression node {type(node).__name__}")

    tree = ast.parse(args.strip(), mode="eval")
    val = ev(tree)
    # Render ints without a trailing .0 so observations stay compact.
    if isinstance(val, float) and val.is_integer() and abs(val) < 1e15:
        val = int(val)
    return str(val)


def _python_exec(args: str, timeout_s: float = 10.0) -> str:
    """Run a program in the OS sandbox (network-off when the kernel
    allows, rlimits always) and return its stdout; nonzero exit raises.
    The per-call wall clock is enforced by the ToolExecutor's timeout
    AND passed through so the sandbox reaps the process group itself."""
    rc, out = run_sandboxed([sys.executable, "-c", args], timeout_s=timeout_s)
    if rc != 0:
        raise ToolError("error", f"exit status {rc}: {out[-500:]}")
    return out


class ToolExecutor:
    """Registry of named tools with per-tool timeouts and fault hooks.

    ``run`` executes the tool on a worker thread bounded by the tool's
    timeout; before running it fires the injector at ``tool:<name>`` so a
    chaos spec (``AREAL_FAULTS="error@point=tool:python_exec&times=1"``)
    can break exactly one execution.  Failures come back as
    :class:`ToolError` with a typed ``kind`` — the controller turns them
    into an error observation instead of killing the episode, because an
    agent seeing "tool failed" is a training signal, not a crash.
    """

    def __init__(
        self,
        timeout_s: float = 10.0,
        faults: Optional[FaultInjector] = None,
        register_builtins: bool = True,
    ):
        self.default_timeout_s = float(timeout_s)
        self.faults = faults if faults is not None else FaultInjector.from_env()
        self._tools: Dict[str, _ToolSpec] = {}
        self._pool = ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="tool"
        )
        if register_builtins:
            self.register("calculator", _calculator)
            # The sandbox tool reads its timeout from its own registry
            # entry at call time, so a later re-register with a custom
            # timeout applies to the subprocess reaper too.
            self.register(
                "python_exec",
                lambda a: _python_exec(
                    a, self._tools["python_exec"].timeout_s
                ),
            )

    def register(
        self,
        name: str,
        fn: Callable[[str], str],
        timeout_s: Optional[float] = None,
    ) -> None:
        self._tools[name] = _ToolSpec(
            fn=fn,
            timeout_s=(
                self.default_timeout_s if timeout_s is None
                else float(timeout_s)
            ),
        )

    def names(self) -> List[str]:
        return sorted(self._tools)

    def run(self, call: ToolCall) -> str:
        """Execute one tool call; returns its observation string or
        raises :class:`ToolError`.  Latency (success or failure) lands in
        ``areal_episode_tool_seconds{tool}``."""
        spec = self._tools.get(call.name)
        t0 = time.monotonic()
        try:
            if spec is None:
                raise ToolError("unknown_tool", call.name)
            if self.faults is not None:
                try:
                    self.faults.fire(f"tool:{call.name}")
                except FaultError as e:
                    raise ToolError("fault", repr(e)) from e
            fut = self._pool.submit(spec.fn, call.args)
            try:
                out = fut.result(timeout=spec.timeout_s + 1.0)
            except FuturesTimeout:
                fut.cancel()
                raise ToolError(
                    "timeout", f"{call.name} > {spec.timeout_s:.1f}s"
                ) from None
            except ToolError:
                raise
            except Exception as e:  # noqa: BLE001 — typed for the agent
                raise ToolError("error", repr(e)) from e
            return str(out)
        except ToolError as e:
            _M_TOOL_ERRORS.labels(call.name, e.kind).inc()
            raise
        finally:
            _M_TOOL_SECONDS.labels(call.name).observe(
                time.monotonic() - t0
            )


# ---------------------------------------------------------------------------
# episode clients (engine-backed; the HTTP client lives in model_api)
# ---------------------------------------------------------------------------


class EngineEpisodeClient:
    """Episode ops against an in-process GeneratorEngine.

    Mirrors the gen server's park loop: when a turn comes back parked
    (``None`` — a weight push interrupted mid-turn), wait for the pusher
    to clear the interrupt, then resume on the same pages.  Weight
    versions are stamped from ``version()`` when provided (the server
    tracks its own counter; in-process harnesses pass a lambda).
    """

    def __init__(
        self,
        engine: Any,
        gconfig: GenerationHyperparameters,
        token_budget: int = 0,
        seed: int = 0,
        version: Optional[Callable[[], int]] = None,
        lock: Optional[threading.Lock] = None,
    ):
        self.engine = engine
        self.gconfig = gconfig
        self.token_budget = int(token_budget)
        self.seed = int(seed)
        self._version = version or (lambda: 0)
        # Serializes episode ops against weight pushes, matching the gen
        # server's engine lock; release it while parked so the pusher can
        # take it.
        self._lock = lock if lock is not None else threading.Lock()

    def version(self) -> int:
        return int(self._version())

    def _drive(self, fn: Callable[[], Optional[Dict]], ep_id: str) -> Dict:
        with self._lock:
            out = fn()
        while out is None:
            while self.engine.interrupt_requested:
                time.sleep(0.005)
            with self._lock:
                out = self.engine.episode_resume(ep_id)
        return out

    def start(self, ep_id: str, prompt_ids: Sequence[int]) -> Dict:
        return self._drive(
            lambda: self.engine.episode_start(
                ep_id,
                list(prompt_ids),
                self.gconfig,
                token_budget=self.token_budget,
                seed=self.seed,
            ),
            ep_id,
        )

    def extend(self, ep_id: str, obs_ids: Sequence[int]) -> Dict:
        return self._drive(
            lambda: self.engine.episode_extend(ep_id, list(obs_ids)),
            ep_id,
        )

    def release(self, ep_id: str) -> None:
        with self._lock:
            self.engine.episode_release(ep_id)


class ServerEpisodeClient:
    """Episode ops over an :class:`~areal_tpu_torch.api.model_api.LLMAPIClient`
    (the HTTP surface); SlotGoneError propagates from the client's typed
    409 handling.  The server parks/resumes internally, so responses are
    always complete turns."""

    def __init__(
        self,
        api_client: Any,
        gconfig: GenerationHyperparameters,
        token_budget: int = 0,
        seed: int = 0,
        trace_id: Optional[str] = None,
    ):
        self.api = api_client
        self.gconfig = gconfig
        self.token_budget = int(token_budget)
        self.seed = int(seed)
        # Rides every turn of the episode to the server (HTTP header /
        # ZMQ frame), keeping the whole multi-turn conversation on one
        # causal timeline.
        self.trace_id = trace_id
        self._last_version = 0

    def version(self) -> int:
        return self._last_version

    def _note_version(self, out: Dict) -> Dict:
        self._last_version = int(out.get("version", self._last_version))
        return out

    def start(self, ep_id: str, prompt_ids: Sequence[int]) -> Dict:
        kw: Dict[str, Any] = {}
        if self.trace_id:
            # Only plumbed when set — duck-typed clients predating the
            # lineage plane keep working without the kwarg.
            kw["trace_id"] = self.trace_id
        return self._note_version(
            self.api.episode_start(
                ep_id, prompt_ids, self.gconfig,
                token_budget=self.token_budget, seed=self.seed, **kw,
            )
        )

    def extend(self, ep_id: str, obs_ids: Sequence[int]) -> Dict:
        return self._note_version(self.api.episode_extend(ep_id, obs_ids))

    def release(self, ep_id: str) -> None:
        self.api.episode_release(ep_id)


# ---------------------------------------------------------------------------
# controller
# ---------------------------------------------------------------------------


class EpisodeController:
    """Drives ``Episode`` state machines over an episode client.

    ``parse_tool_call(tokens) -> Optional[ToolCall]`` inspects a finished
    assistant turn (the stop-sequence tokens are KEPT in the output, so
    the parser sees the full call); ``encode_observation(call, text,
    ok) -> tokens`` renders the tool result back into model tokens.
    Both are injected: the wire format of a tool call belongs to the
    chat template, not the serving plane.

    Terminal conditions, in precedence order: the turn ended without a
    stop sequence (eos / length / budget), the parser found no tool call
    (``no_tool_call``), or ``max_turns`` assistant turns completed.
    """

    def __init__(
        self,
        client: Any,
        tools: ToolExecutor,
        parse_tool_call: Callable[[List[int]], Optional[ToolCall]],
        encode_observation: Callable[[ToolCall, str, bool], List[int]],
        max_turns: int = 4,
    ):
        if max_turns < 1:
            raise ValueError(f"max_turns must be >= 1, got {max_turns}")
        self.client = client
        self.tools = tools
        self.parse_tool_call = parse_tool_call
        self.encode_observation = encode_observation
        self.max_turns = int(max_turns)

    # -- client ops with SlotGone recovery --------------------------------

    def _extend_or_readmit(
        self, ep: Episode, obs: List[int]
    ) -> Dict:
        """Append the observation; if the serving side reclaimed our slot
        (eviction under pool pressure, server restart), re-admit the FULL
        conversation — the published transcript prefixes turn that into a
        near-free shared admission plus an observation-sized prefill.
        The observation's tool turn is already on ``ep.turns``, so the
        re-admission transcript ends with ``obs``."""
        try:
            return self.client.extend(ep.episode_id, obs)
        except SlotGoneError as e:
            ep.slot_lost += 1
            transcript = ep.transcript()
            logger.warning(
                f"episode {ep.episode_id}: slot lost ({e.reason}); "
                f"re-admitting {len(transcript)} tokens via the prefix "
                f"cache"
            )
            return self.client.start(ep.episode_id, transcript)

    # -- the loop ---------------------------------------------------------

    def run_episode(
        self,
        episode_id: str,
        prompt_ids: Sequence[int],
        trace_id: Optional[str] = None,
    ) -> Episode:
        ep = Episode(episode_id=episode_id, prompt_ids=list(prompt_ids))
        # Child spans carry the trace_id only when the dispatcher minted one.
        targs: Dict[str, Any] = {"trace_id": trace_id} if trace_id else {}
        _M_ACTIVE.inc()
        try:
            v0 = self.client.version()
            with tracer.span("episode_turn", episode_id=episode_id, turn=0, **targs):
                out = self.client.start(episode_id, prompt_ids)
            while True:
                reason = str(out.get("stop_reason", ""))
                ep.turns.append(
                    Turn(
                        index=len(ep.turns),
                        role="assistant",
                        tokens=[int(t) for t in out.get("tokens", [])],
                        logprobs=[
                            float(x) for x in out.get("logprobs", [])
                        ],
                        stop_reason=reason,
                        version=self.client.version(),
                        version_start=v0,
                    )
                )
                _M_TURNS.labels(reason or "unknown").inc()
                if reason != "stop":
                    ep.stop_reason = reason or "unknown"
                    break
                if ep.assistant_turns >= self.max_turns:
                    ep.stop_reason = "max_turns"
                    break
                call = self.parse_tool_call(ep.turns[-1].tokens)
                if call is None:
                    ep.stop_reason = "no_tool_call"
                    break
                t0 = time.monotonic()
                try:
                    result = self.tools.run(call)
                    ok = True
                except ToolError as e:
                    result = f"tool error ({e.kind}): {e.detail}"
                    ok = False
                latency = time.monotonic() - t0
                obs = [
                    int(t)
                    for t in self.encode_observation(call, result, ok)
                ]
                ep.turns.append(
                    Turn(
                        index=len(ep.turns),
                        role="tool",
                        tokens=obs,
                        tool_name=call.name,
                        tool_ok=ok,
                        tool_latency_s=latency,
                        version=self.client.version(),
                        version_start=self.client.version(),
                    )
                )
                v0 = self.client.version()
                with tracer.span("episode_turn", episode_id=episode_id,
                                 turn=len(ep.turns), **targs):
                    out = self._extend_or_readmit(ep, obs)
        finally:
            _M_ACTIVE.dec()
            try:
                self.client.release(ep.episode_id)
            except Exception:  # noqa: BLE001 — slot may already be gone
                pass
        ep.status = "done"
        _M_EPISODES.labels(ep.stop_reason).inc()
        return ep


def make_episode_runner(
    tools: ToolExecutor,
    parse_tool_call: Callable[[List[int]], Optional[ToolCall]],
    encode_observation: Callable[[ToolCall, str, bool], List[int]],
    gconfig: GenerationHyperparameters,
    max_turns: int = 4,
    token_budget: int = 0,
    seed: int = 0,
) -> Callable[[Any, str, Sequence[int]], Episode]:
    """Build the ``episode_runner(client, qid, prompt_ids)`` hook the
    rollout controller dispatches episodes through: each call wraps the
    chosen server's API client in a :class:`ServerEpisodeClient` and
    runs one full episode against it (slot pinning means the whole
    episode stays on that server)."""

    def run(
        api_client: Any,
        qid: str,
        prompt_ids: Sequence[int],
        trace_id: Optional[str] = None,
    ) -> Episode:
        controller = EpisodeController(
            ServerEpisodeClient(
                api_client, gconfig, token_budget=token_budget, seed=seed,
                trace_id=trace_id,
            ),
            tools,
            parse_tool_call,
            encode_observation,
            max_turns=max_turns,
        )
        return controller.run_episode(qid, prompt_ids, trace_id=trace_id)

    return run


# ---------------------------------------------------------------------------
# asynchronous reward grading
# ---------------------------------------------------------------------------


class RewardFabric:
    """Asynchronous front of the verifier registry: ``submit`` hands a
    grading job to a bounded thread pool and returns a Future.

    ``remote`` is anything with ``verify_batch(items)`` (the reward
    service's ``RemoteVerifier``: typed retries, then local fallback);
    without one, jobs grade in-process through the registry the service
    dispatches on.  ``on_result(task, passed)`` fires as each grade
    completes."""

    def __init__(self, remote: Any = None, max_workers: int = 8,
                 on_result: Optional[Callable[[str, bool], None]] = None):
        self.remote = remote
        self.on_result = on_result
        self._pool = ThreadPoolExecutor(max_workers=max_workers, thread_name_prefix="reward")

    def _grade(self, item: Dict[str, Any]) -> bool:
        if self.remote is not None:
            ok = bool(self.remote.verify_batch([item])[0])
        else:
            from areal_tpu_torch.interfaces.reward_service import grade_item

            ok = bool(grade_item(item))
        if self.on_result is not None:
            try:
                self.on_result(str(item.get("task", "")), ok)
            except Exception:  # noqa: BLE001 — the hook is advisory
                logger.exception("reward on_result hook failed")
        return ok

    def submit(self, task: str, text: str, payload: Dict[str, Any], trace_id: str = ""):
        """Grade asynchronously; the item travels in the opaque
        ``{"task", "text", "payload"}`` schema."""
        item = {"task": task, "text": text, "payload": dict(payload)}
        if trace_id:
            item["trace_id"] = trace_id
        return self._pool.submit(self._grade, item)

    def grade(self, task: str, text: str, payload: Dict[str, Any],
              timeout_s: Optional[float] = None) -> bool:
        return self.submit(task, text, payload).result(timeout=timeout_s)

    def close(self) -> None:
        self._pool.shutdown(wait=True)
