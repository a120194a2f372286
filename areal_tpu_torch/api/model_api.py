"""Model/algorithm API (port of areal_tpu/api/model_api.py): generation
request/config dataclasses with the JAX package's fields and wire names,
`SlotGoneError`, the stdlib-HTTP `LLMAPIClient` of a generation server
(with `BoundedAgenerateMixin`'s bounded asyncio fan-out), the optimizer
and finetune specs, the `Model` bundle, and the `ModelInterface`
registry."""

import dataclasses
import json
import os
import urllib.error
import urllib.request
from typing import Any, Dict, Optional, Tuple

from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
from areal_tpu_torch.models.config import ModelConfig


@dataclasses.dataclass
class GenerationHyperparameters:
    """Sampling config."""

    n: int = 1  # group size (responses per prompt)
    max_new_tokens: int = 256
    min_new_tokens: int = 0
    greedy: bool = False
    top_p: float = 1.0
    top_k: int = 0  # 0 = disabled
    temperature: float = 1.0
    # Speculative decoding: K n-gram drafts a step, verified exactly.
    spec_decode_k: int = 0
    spec_ngram: int = 3
    # Stop sequences: tuple of token-id tuples; a row whose tail matches
    # one finishes there (the stop tokens stay in the output).  Normalized
    # to tuples so the config stays hashable and survives a JSON trip.
    stop: tuple = ()

    def __post_init__(self):
        self.stop = tuple(tuple(int(t) for t in s) for s in self.stop)

    def new(self, **kwargs):
        return dataclasses.replace(self, **kwargs)


class SlotGoneError(RuntimeError):
    """An episode continuation targeted a slot the serving side no longer
    holds (evicted under pool pressure, released, or the server
    restarted).  Typed, not a silent fresh admission, so the episode
    controller recovers deliberately: it re-admits the full
    conversation, which the prefix cache turns into a tail prefill.
    Raised by the engine; clients rebuild it from the server's
    ``{"error_type": "slot_gone"}`` reply (HTTP 409)."""

    def __init__(self, episode_id: str, reason: str = "unknown"):
        super().__init__(f"episode {episode_id!r}: slot gone ({reason})")
        self.episode_id = episode_id
        self.reason = reason


@dataclasses.dataclass
class APIGenerateInput:
    """One generation request to a generation server."""

    qid: str
    prompt_ids: list  # List[int]
    gconfig: GenerationHyperparameters
    # Seeded requests only co-batch with same-seed requests server-side.
    seed: Optional[int] = None
    trace_id: Optional[str] = None


@dataclasses.dataclass
class APIGenerateOutput:
    """Grouped responses for one request."""

    qid: str
    prompt_ids: list  # List[int]
    output_ids: list  # List[List[int]] — gconfig.n responses
    output_logprobs: list  # List[List[float]]
    no_eos: list  # List[bool] — hit max_new_tokens without EOS
    version: int = 0  # server weight version that produced this
    version_start: int = 0  # weight version sampling started under

    @classmethod
    def from_input(cls, inp: "APIGenerateInput") -> "APIGenerateOutput":
        return cls(
            qid=inp.qid, prompt_ids=list(inp.prompt_ids),
            output_ids=[], output_logprobs=[], no_eos=[],
        )

    @property
    def prompt_len(self) -> int:
        return len(self.prompt_ids)

    @property
    def output_lens(self) -> list:
        return [len(x) for x in self.output_ids]


class BoundedAgenerateMixin:
    """Bounds the asyncio fan-out of `agenerate`: each call runs the
    blocking `generate` in `asyncio.to_thread`, and an unbounded caller
    (a rollout controller dispatching hundreds of prompts) would exhaust
    the default thread pool and starve every other to_thread user.  A
    semaphore a running event loop, sized `max_inflight` (the server's
    serving capacity), caps the client's concurrent threads."""

    max_inflight: int = 64

    def _agen_sem(self):
        import asyncio

        sems = getattr(self, "_agen_sems", None)
        if sems is None:
            sems = self._agen_sems = {}
        # asyncio primitives bind to a loop: one semaphore a loop.
        loop = asyncio.get_running_loop()
        sem = sems.get(id(loop))
        if sem is None:
            sem = sems[id(loop)] = asyncio.Semaphore(max(1, int(self.max_inflight)))
        return sem

    async def agenerate(self, inp: "APIGenerateInput") -> "APIGenerateOutput":
        import asyncio

        async with self._agen_sem():
            return await asyncio.to_thread(self.generate, inp)


class LLMAPIClient(BoundedAgenerateMixin):
    """Client of a GenerationServer over HTTP (standard library only),
    speaking the JAX package's wire format: `generate`,
    `generate_batch`, `agenerate`, `update_weights_from_disk`, `pause`,
    `resume`, `health` and the agent episode ops.

        client = LLMAPIClient("http://127.0.0.1:8091")
        out = client.generate(APIGenerateInput(qid="q", prompt_ids=[1, 2],
                                               gconfig=GenerationHyperparameters()))
        outs = client.generate_batch([inp1, inp2])  # co-batched server-side
        turn = client.episode_start("ep0", prompt_ids, gconfig, token_budget=2048)
    """

    def __init__(self, url: str, timeout_s: float = 7200.0, token: str = "",
                 max_inflight: int = 64):
        self.url = url.rstrip("/")
        self.timeout_s = timeout_s
        self.token = token or os.environ.get("AREAL_GEN_TOKEN", "")
        self.max_inflight = max_inflight

    def _post(self, path: str, payload: Dict, trace_id: Optional[str] = None) -> Dict:
        headers = {"Content-Type": "application/json"}
        if self.token:
            headers["X-Areal-Token"] = self.token
        if trace_id:
            headers["X-Areal-Trace"] = trace_id
        req = urllib.request.Request(
            self.url + path, data=json.dumps(payload).encode(), headers=headers
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                out = json.loads(r.read())
        except urllib.error.HTTPError as e:
            # The server's error body ({"error": ...}, or the typed
            # slot_gone payload) says more than the status line.
            try:
                body = json.loads(e.read())
            except Exception:  # noqa: BLE001 — no JSON body
                body = {}
            if body.get("error_type") == "slot_gone":
                raise SlotGoneError(
                    str(body.get("episode_id", "")), str(body.get("reason", "unknown"))
                ) from e
            raise RuntimeError(
                f"generation server {path} failed: HTTP {e.code} {body.get('error', '')}"
            ) from e
        if "error" in out:
            raise RuntimeError(f"generation server error: {out['error']}")
        return out

    def health(self) -> Dict:
        with urllib.request.urlopen(self.url + "/health", timeout=30.0) as r:
            return json.loads(r.read())

    def generate(self, inp: APIGenerateInput) -> APIGenerateOutput:
        g = inp.gconfig
        out = self._post(
            "/generate",
            {
                "qid": inp.qid,
                "prompt_ids": [int(t) for t in inp.prompt_ids],
                "n": g.n,
                "max_new_tokens": g.max_new_tokens,
                "min_new_tokens": g.min_new_tokens,
                "greedy": g.greedy,
                "top_p": g.top_p,
                "top_k": g.top_k,
                "temperature": g.temperature,
                "spec_decode_k": g.spec_decode_k,
                "spec_ngram": g.spec_ngram,
                "stop": [list(s) for s in g.stop],
                "seed": inp.seed,
            },
            trace_id=inp.trace_id,
        )
        return APIGenerateOutput(
            qid=inp.qid,
            prompt_ids=list(inp.prompt_ids),
            output_ids=out["output_ids"],
            output_logprobs=out["output_logprobs"],
            no_eos=out["no_eos"],
            version=int(out.get("version", 0)),
            version_start=int(out.get("version_start", out.get("version", 0))),
        )

    def generate_batch(self, inps: "list[APIGenerateInput]",
                       max_concurrency: int = 64) -> "list[APIGenerateOutput]":
        """Issue the requests concurrently; the server merges them into
        shared engine calls."""
        from concurrent.futures import ThreadPoolExecutor

        if not inps:
            return []
        with ThreadPoolExecutor(max_workers=min(max_concurrency, len(inps))) as ex:
            return list(ex.map(self.generate, inps))

    def update_weights_from_disk(self, path: str) -> int:
        """Swap the server's weights for an HF checkpoint dir; returns the
        new weight version."""
        return int(self._post("/update_weights", {"path": path})["version"])

    def push_weights(self, meta: Dict, payload) -> Dict:
        """The binary weight push of the param store
        (`system/paramstore.py`): ``POST /param_push`` with an
        octet-stream body, the 8-byte big-endian meta length, the meta
        JSON and the raw serialized params (any bytes-like object, sent
        as it is).  Returns the server's ack."""
        from areal_tpu_torch.system.paramstore import push_prefix

        head = push_prefix(meta)
        headers = {"Content-Type": "application/octet-stream",
                   "Content-Length": str(len(head) + memoryview(payload).nbytes)}
        if self.token:
            headers["X-Areal-Token"] = self.token
        # Two chunks: the payload (gigabytes) is never joined into a copy.
        req = urllib.request.Request(self.url + "/param_push",
                                     data=[head, memoryview(payload).cast("B")],
                                     headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                out = json.loads(r.read())
        except urllib.error.HTTPError as e:
            try:
                err = json.loads(e.read()).get("error", "")
            except Exception:  # noqa: BLE001 — the status says enough
                err = ""
            raise RuntimeError(f"generation server /param_push failed: HTTP {e.code} {err}") from e
        if "error" in out:
            raise RuntimeError(f"generation server error: {out['error']}")
        return out

    def pause(self) -> Dict:
        """Park in-flight decoding at the next chunk boundary."""
        return self._post("/pause", {})

    def resume(self) -> Dict:
        return self._post("/resume", {})

    # Agent episodes: multi-turn tool use on the server's parked KV
    # pages.  episode_extend raises SlotGoneError when the server
    # reclaimed the episode's slot; the controller then starts the full
    # conversation again.

    def episode_start(
        self, episode_id: str, prompt_ids, gconfig: GenerationHyperparameters,
        token_budget: int = 0, seed: int = 0, trace_id: Optional[str] = None,
    ) -> Dict:
        return self._post(
            "/episode",
            {
                "op": "start",
                "episode_id": episode_id,
                "prompt_ids": [int(t) for t in prompt_ids],
                "gconfig": dataclasses.asdict(gconfig),
                "token_budget": int(token_budget),
                "seed": int(seed),
            },
            trace_id=trace_id,
        )

    def episode_extend(self, episode_id: str, obs_ids) -> Dict:
        return self._post(
            "/episode",
            {"op": "extend", "episode_id": episode_id, "obs_ids": [int(t) for t in obs_ids]},
        )

    def episode_release(self, episode_id: str) -> Dict:
        return self._post("/episode", {"op": "release", "episode_id": episode_id})


@dataclasses.dataclass
class OptimizerConfig:
    """AdamW with global-norm clipping and an lr schedule."""

    type: str = "adam"
    lr: float = 2e-5
    weight_decay: float = 0.05
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-5
    min_lr_ratio: float = 0.0
    lr_scheduler_type: str = "constant"  # constant | linear | cosine
    warmup_steps_proportion: float = 0.02
    gradient_clipping: float = 1.0


@dataclasses.dataclass
class FinetuneSpec:
    total_train_epochs: int = 1
    dataset_size: int = 0
    train_batch_size: int = 1

    @property
    def steps_per_epoch(self) -> int:
        return max(
            1, (self.dataset_size + self.train_batch_size - 1) // self.train_batch_size
        )

    @property
    def total_train_steps(self) -> int:
        return self.total_train_epochs * self.steps_per_epoch


@dataclasses.dataclass
class Model:
    """A named model bundle: an engine (TrainEngine or GeneratorEngine),
    its tokenizer and config, and the weight version."""

    name: str
    engine: Any
    tokenizer: Any
    config: Optional[ModelConfig]
    version: int = 0

    def inc_version(self):
        self.version += 1


def data_shard_info(engine) -> Tuple[int, int]:
    """(shard_rank, n_shards) of the batch rows this process places for
    `engine`: the master's shard-exact dispatch ships an SPMD group
    member only its own row block when n_shards > 1.  An engine without a
    device mesh (or whose mesh does not split the batch) reports (0, 1),
    "ship me everything"."""
    mesh = getattr(engine, "mesh", None)
    if mesh is None:
        return (0, 1)
    from areal_tpu_torch.base.topology import local_batch_shard

    return local_batch_shard(mesh)


ALL_INTERFACES: Dict[str, type] = {}


class ModelInterface:
    """An algorithm: maps (model, data) -> data or stats.  Subclasses
    override any subset."""

    def generate(
        self, model: Model, sample: SequenceSample, mb_spec: MicroBatchSpec
    ) -> SequenceSample:
        raise NotImplementedError

    def inference(
        self, model: Model, sample: SequenceSample, mb_spec: MicroBatchSpec
    ) -> SequenceSample:
        raise NotImplementedError

    def train_step(
        self, model: Model, sample: SequenceSample, mb_spec: MicroBatchSpec
    ) -> Dict[str, float]:
        raise NotImplementedError

    def state_dict(self) -> Dict[str, Any]:
        return {}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        pass


def register_interface(name: str, cls: type) -> None:
    if name in ALL_INTERFACES:
        raise ValueError(f"interface {name!r} already registered")
    ALL_INTERFACES[name] = cls


def make_interface(name: str, **kwargs) -> ModelInterface:
    return ALL_INTERFACES[name](**kwargs)
