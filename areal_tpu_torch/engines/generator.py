"""Generation engine: the static path, the unified serving plane over a
paged KV pool, and the other inflight modes of the JAX engine (port of
areal_tpu/engines/generator.py).

`GeneratorEngine.generate` chooses its path as the JAX engine does: stop
sequences go to the serving plane; otherwise, unless the caller says,
a call with more requests than `max_decode_batch`, or with more than
`static_path_max_new` new tokens, goes to the serving plane and every
other call takes the static path.

The static path (`_generate_chunk`): length-sorted chunks of at most
`max_decode_batch` requests, each one program over a dense KV cache —
right-aligned prompts, one `prefill` (K1f on the card), then one
`decode_step` (K4 on the card) per token until every row is done or the
token budget is spent.

The serving plane: a fixed slot pool where admitted prompts are
consumed in `prefill_chunk_tokens` (W) sized slices INSIDE the same
ragged chunk step that advances live decodes, finished rows retire
between chunks, and same-prompt repeats (a GRPO group's n responses) map
the owner's full prompt pages copy-on-write.  Each chunk runs `chunk_t`
inner steps on the device — lane grants, sampling and one
`decode_step_ragged_paged` forward each — and syncs with the host once,
at its end.

Interruptible generation (the in-memory weight push of asynchronous RL):
`interrupt()` makes the serving loop park at its next chunk boundary,
and `generate` then returns None; after the caller swaps the weights
(`set_params`), `resume_generate()` replays each live row's last chunk
through `decode_step_spec_paged` (K3 on the card) under the CURRENT
weights — rewriting that tail's KV on its already-mapped pages and
refreshing the next-token logits — and continues the loop, so a push
costs one chunk of replay, not a drain and a full re-prefill.  A static
call is one program: it ignores interrupt() and finishes whole, as in
the JAX package.

The other inflight modes, chosen as the JAX engine chooses them
(`_generate_inflight`):
- kv_paged=False, the dense window: a [L, n_slots, S] cache that grows
  by doubling buckets (`cache_copy_bytes` counts the copies); admissions
  are one batched `prefill_into_slots` (K1f) per refill, then chunks of
  `decode_step_inflight` (K4 at Q=1), in bf16 or with an int8 cache.
  With spec_decode_k = K > 0 each step is one `decode_step_spec` (K4 at
  Q = K+1) over the pending token and K n-gram drafts
  (`ops/ngram.propose_ngram`), verified exactly by
  `ops/sampling.spec_accept`.
- kv_paged=True with prefill_chunk_tokens=0, the two-program paged
  path: one batched `prefill_into_pages` (K1f) per refill, then chunks
  of `decode_step_paged` (K2's kernel, one token a slot).  Spec decoding
  there raises ValueError, as in the JAX package: it rides the serving
  plane, where a speculating row forwards its pending token and K
  drafts as K+1 lanes of the packed stream (K2).
Every chunk runs its steps on the device with done rows masked, and the
host reads its results once, at its end.

Agent episodes (`episode_start/extend/resume/release`): multi-turn tool
use on an engine-lifetime serving session whose geometry the first
episode fixes.  Each assistant turn decodes through the serving chunk
(K2) until a stop sequence, EOS or a budget; the slot then parks with
its KV pages held, the observation is chunk-prefilled onto the same
pages, and the next turn forwards only the observation.  Parked slots
ride the packed stream as done rows (zero lanes).  A push during a turn
parks it (the call returns None); `episode_resume` replays the slot's
last chunk tail through K3 under the new weights and continues.

Tracing (`base/tracer.py`): a ``generate`` span around each call, and
compute spans ``gen_chunk`` (a static burst), ``serving_chunk``,
``episode_chunk`` and ``decode_chunk`` (an inflight chunk), each ending
at the host read of its outputs, so each covers its device work.
``prefill``, ``resume_replay`` and ``episode_resume_replay`` close at
their launch (the device work lands in the next chunk's span), except
the speculative admission's ``prefill``, which reads its first tokens.
No span adds a synchronization.  The ``kv_pool``, ``gen_slots`` and
``gen_interrupt`` counters sample the pool and the slots.

Metrics (`base/metrics.py`, the JAX engine's series): the KV gauges
(``areal_gen_kv_utilization_ratio``, ``_kv_live_tokens``,
``_kv_allocated_tokens``) at each chunk's pool sample,
``areal_gen_live_slots`` wherever the live slot count changes,
``areal_gen_tokens_total`` and ``areal_gen_goodput_tokens_per_second``
(response tokens over the whole call's wall time, park time included)
when a call assembles its output, and ``areal_gen_decode_compiles_total``
beside `decode_compiles`: on the card these count chunk-function builds,
not XLA compiles.  Every value comes from host integers the loop already
holds; none reads the device.
"""

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model_api import GenerationHyperparameters, SlotGoneError
from areal_tpu_torch.base import metrics, tracer
from areal_tpu_torch.base.device import resolve_device
from areal_tpu_torch.engines.packing import bucket_len
from areal_tpu_torch.engines.paging import PageAllocator, PagePoolExhausted
from areal_tpu_torch.models import transformer as tfm
from areal_tpu_torch.models.config import ModelConfig
from areal_tpu_torch.ops.ngram import propose_ngram
from areal_tpu_torch.ops.sampling import sample_token, spec_accept


def _find_stop_end(toks, scan_from: int, stop_seqs) -> Optional[int]:
    """Earliest index just PAST a completed stop sequence whose match
    ends after `scan_from` — so a sequence straddling two decode chunks
    is still caught, exactly once.  None when nothing matches."""
    best = None
    for seq in stop_seqs:
        L = len(seq)
        if L == 0 or len(toks) < L:
            continue
        target = list(seq)
        for i in range(max(0, scan_from - L + 1), len(toks) - L + 1):
            if toks[i : i + L] == target:
                end = i + L
                if best is None or end < best:
                    best = end
                break
    return best


def _spec_emit(
    cfg, g, eos, rows, logits, drafts, generator, pending, cache_len, gen_count,
    done, out_toks, out_logps, out_fill, out_w, tokens_buf, buf_w, active=None,
    n_valid=None,
):
    """One speculative step's bookkeeping after its forward, shared by the
    dense window and the serving plane so their emission cannot diverge:
    the min_new_tokens EOS mask, exact verification (`spec_accept`),
    truncation at the first EOS (kept), and appends to the chunk's output
    buffers and the history buffer.

    `active` [B] (default ~done) marks the rows that emit this step;
    `n_valid` [B] is each row's count of forwarded positions (ragged
    verification).  out_toks/out_logps (logical width out_w) and
    tokens_buf (logical width buf_w) are written in place and carry K + 1
    scratch columns past their logical width: the entries past a row's
    emission count, which the JAX package writes as no-ops or drops, land
    there.  Returns (pending, cache_len, gen_count, done, out_fill)."""
    K = g.spec_decode_k
    dev = logits.device
    if active is None:
        active = ~done
    j_idx = torch.arange(K + 1, device=dev)[None, :]
    if g.min_new_tokens > 0:
        not_enough = (gen_count[:, None] + j_idx) < g.min_new_tokens
        eos_col = torch.arange(cfg.vocab_size, device=dev) == eos
        logits = logits.masked_fill(not_enough[:, :, None] & eos_col[None, None, :], -1e10)
    emitted, logps, n_emit = spec_accept(
        logits, drafts, generator, temperature=g.temperature, top_k=g.top_k,
        top_p=g.top_p, greedy=g.greedy, n_valid=n_valid,
    )
    n_emit = torch.where(active, n_emit, 0)
    # Truncate at the first EOS (inclusive).
    is_eos = (emitted == eos) & (j_idx < n_emit[:, None])
    eos_pos = torch.amin(torch.where(is_eos, j_idx, K + 1), dim=1)
    n_emit = torch.minimum(n_emit, eos_pos + 1)
    new_done = done | (active & is_eos.any(dim=1))
    valid = j_idx < n_emit[:, None]
    cols = torch.where(valid, out_fill[:, None] + j_idx, out_w + j_idx)
    out_toks[rows[:, None], cols] = torch.where(valid, emitted, -1)
    out_logps[rows[:, None], cols] = torch.where(valid, logps, 0.0)
    # History: the emitted tokens sit at positions cache_len + 1 ...
    bcols = torch.where(
        valid, torch.clamp(cache_len[:, None] + 1 + j_idx, max=buf_w - 1), buf_w + j_idx
    )
    tokens_buf[rows[:, None], bcols] = emitted
    new_pending = torch.gather(emitted, 1, torch.clamp(n_emit - 1, 0, K)[:, None])[:, 0]
    pending = torch.where(done | (n_emit == 0), pending, new_pending)
    return pending, cache_len + n_emit, gen_count + n_emit, new_done, out_fill + n_emit


@dataclasses.dataclass
class _EpisodeSlot:
    """Host bookkeeping of one live episode pinned to a serving slot.
    The transcript lives in the shared session (`slot_prompt[s]` holds
    every forwarded token, the page table its KV); this is the episode's
    state machine: turns, the per-turn budget, and whether an interrupt
    parked it mid-turn."""

    ep_id: str
    slot: int
    gconfig: GenerationHyperparameters
    token_budget: int  # max transcript tokens
    turns: int = 0
    seq: int = 0  # LRU tick, bumped at every admission; eviction takes the min
    turn_start_len: int = 0  # transcript tokens when this turn began
    last_admit_tokens: int = 0  # teacher-forced tokens of this call
    turn_max_new: int = 0  # the turn's budget after the clamp
    budget_limited: bool = False  # turn_max_new was clamped by the budget
    parked_mid_turn: bool = False  # an interrupt parked it inside a turn


@dataclasses.dataclass
class _PagedGenSession:
    """Everything the serving chunk loop carries between chunks, host
    and device side, for one generate call — also the parked state of an
    interrupted call, which `resume_generate()` continues.  The
    torch.Generator rides along and the replay draws nothing from it, so
    a resume under unchanged weights is token-identical to an
    uninterrupted run."""

    gconfig: GenerationHyperparameters
    generator: torch.Generator  # on the engine's device
    results: Dict
    n_slots: int
    n_pages: int
    max_pages: int
    chunk_t: int
    alloc: PageAllocator
    pool: tfm.PagedKVCache  # device, updated in place
    logits_buf: torch.Tensor  # device [n_slots, vocab] f32, updated in place
    cache_len: np.ndarray
    gen_count: np.ndarray
    done_host: np.ndarray
    active: List[Optional[Tuple[int, int]]]
    toks_acc: Dict[int, List[int]]
    logps_acc: Dict[int, List[float]]
    pending: List
    # Per-slot prompt tokens + last chunk's emission count: together they
    # define the tail to replay on resume (history = prompt + toks_acc).
    slot_prompt: Dict[int, np.ndarray]
    last_emit: np.ndarray  # [n_slots] int32
    # Per-row prefill progress: prompt_buf[slot] holds the not-yet-
    # forwarded prompt remainder, prefill_rem counts tokens still to
    # consume, prompt_off indexes the next prompt_buf read.  A row with
    # prefill_rem > 0 is admitting; 0 means decoding.
    prefill_chunk: int  # W = query lanes per row per inner step
    prompt_buf: np.ndarray  # [n_slots, pbw] int32
    prefill_rem: np.ndarray  # [n_slots] int32
    prompt_off: np.ndarray  # [n_slots] int32
    # First PRIVATE flat position per slot (shared prompt pages end
    # here): 0 for owners, sp * page_size for prefix-cache followers.
    # The resume replay never writes below it.
    shared_from: np.ndarray  # [n_slots] int32
    slot_hash: Dict[int, bytes]  # prompt hash per owner slot
    # hash -> owner slot still prefilling it; followers wait for it.
    inflight_prefix: Dict[bytes, int]
    peak_live: int = 0
    # Speculative decoding on the serving plane: the device history
    # buffer (prompt + emitted tokens, read by the in-chunk n-gram
    # proposer; K + 1 scratch columns past its width buf_w) and each
    # row's sampled but not yet forwarded token.
    tokens_buf: Optional[torch.Tensor] = None  # [n_slots, buf_w + K + 1]
    pending_tok: Optional[torch.Tensor] = None  # [n_slots]
    # Assembly context, stashed by generate() when the call parks so
    # resume_generate() can return the finished SequenceSample.
    sample: Optional[SequenceSample] = None
    prompt_key: str = "packed_prompts"
    prompt_lens: Optional[List[int]] = None
    n: int = 1
    # Agent episodes (the engine-lifetime session only): ep_id ->
    # _EpisodeSlot of every episode pinning a slot (active[s] holds its
    # ep_id), the LRU tick source, the default per-episode token budget,
    # and the serving chunk functions built for it, by signature, each
    # with its lane budget T.
    episodes: Optional[Dict[str, "_EpisodeSlot"]] = None
    ep_seq: int = 0
    ep_budget: int = 0
    chunk_fns: Optional[Dict[tuple, Tuple[Any, int]]] = None


class GeneratorEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params: Dict[str, Any],
        device=None,
        *,
        eos_token_id: int,
        pad_token_id: Optional[int] = None,
        compute_dtype: Optional[torch.dtype] = None,
        max_decode_batch: int = 64,
        kv_cache_dtype: str = "auto",
        kv_paged: bool = True,
        kv_page_size: int = 128,
        kv_pool_pages: int = 0,
        prefill_chunk_tokens: int = 8,
        kv_share_prefix: bool = True,
        serving_admit_lanes: int = 0,
    ):
        if cfg.is_critic:
            raise ValueError("cannot generate from a critic model")
        if prefill_chunk_tokens < 0:
            raise ValueError(
                "prefill_chunk_tokens must be >= 0 (0 = the two-program "
                f"admit path), got {prefill_chunk_tokens}"
            )
        if kv_cache_dtype not in ("auto", "int8"):
            raise ValueError(
                f"kv_cache_dtype must be 'auto' or 'int8', got {kv_cache_dtype!r}"
            )
        if kv_page_size < 1:
            raise ValueError(f"kv_page_size must be >= 1, got {kv_page_size}")
        if kv_pool_pages < 0 or serving_admit_lanes < 0:
            raise ValueError("kv_pool_pages and serving_admit_lanes must be >= 0")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.eos_token_id = int(eos_token_id)
        self.pad_token_id = int(pad_token_id or eos_token_id)
        # fp32 on the host (the JAX package forces fp32 on CPU too), bf16
        # on the card; attention accumulates in fp32 either way.
        if compute_dtype is None:
            compute_dtype = (
                torch.float32 if self.device.type == "cpu" else torch.bfloat16
            )
        self.compute_dtype = compute_dtype
        self.max_decode_batch = int(max_decode_batch)
        # Token budget above which generate() leaves the static path even
        # when every request fits one chunk: the static program allocates
        # its whole window up front and decodes without a chunk boundary.
        self.static_path_max_new = 2048
        self.kv_cache_dtype = kv_cache_dtype
        # False: the dense inflight window instead of the paged pool.
        self.kv_paged = bool(kv_paged)
        self.kv_page_size = int(kv_page_size)
        # 0 = auto: every slot at prompt + max_new_tokens.
        self.kv_pool_pages = int(kv_pool_pages)
        self.prefill_chunk_tokens = int(prefill_chunk_tokens)
        self.kv_share_prefix = bool(kv_share_prefix)
        # Lane headroom A of the packed stream (0 = auto, 4 * W).
        self.serving_admit_lanes = int(serving_admit_lanes)
        self.serving_lane_budget = 0
        # Per-generate counters (reset in generate()).  decode_compiles
        # counts decode-chunk function builds: the serving chunk once per
        # loop, the other modes once per distinct shape in the call (the
        # dense window rebuilds per bucket, as the JAX engine recompiles);
        # prefill_dispatches counts standalone prefill programs (the
        # serving plane runs none); cache_copy_bytes counts the dense
        # window's growth copies.  Lane accounting: lanes_dispatched =
        # chunk steps x T, lanes_live carry a real token, lanes_slack are
        # budgeted but idle, dead_live_lanes (live lanes mapped to no row)
        # is structurally 0.
        self.prefill_dispatches = 0
        self.decode_compiles = 0
        self.cache_copy_bytes = 0
        self._chunk_fns: Dict[tuple, Any] = {}
        self.last_pool_stats: Dict[str, Any] = {}
        self.lanes_dispatched = 0
        self.lanes_live = 0
        self.lanes_slack = 0
        self.dead_live_lanes = 0
        # Inner steps (decode forwards) of every inflight mode run over
        # the engine's life, and the static path's chunks (one prefill
        # each) and decode steps — never reset.
        self.steps_total = 0
        self.static_chunks = 0
        self.static_decode_steps = 0
        # Load gauges for the server's /health: (live_slots,
        # kv_utilization) replaced as one tuple.
        self.kv_utilization = 0.0
        self.live_slots = 0
        self.load_state = (0, 0.0)
        # Interruptible generation: the event parks the serving loop at
        # its next chunk boundary; the parked session waits in _session
        # for resume_generate().  resume_replays counts the resumes that
        # replayed at least one live row (each one runs K3 once per layer).
        self._interrupt_evt = threading.Event()
        self._session: Optional[_PagedGenSession] = None
        self.resume_replays = 0
        # Agent episodes: the engine-lifetime serving session they pin
        # slots in, made by the first episode_start(); its counters are
        # never reset.
        self._ep_session: Optional[_PagedGenSession] = None
        self.episodes_started = 0
        self.episodes_evicted = 0
        self.episode_prefix_hits = 0
        self.episode_prefix_misses = 0
        reg = metrics.default_registry()
        self._m_tokens = reg.counter("areal_gen_tokens_total", "response tokens generated")
        self._m_goodput = reg.gauge(
            "areal_gen_goodput_tokens_per_second",
            "tokens/s over the last completed generate call",
        )
        self._m_decode_compiles = reg.counter(
            "areal_gen_decode_compiles_total",
            "jitted decode-chunk program compiles",
        )
        self._m_kv_util = reg.gauge(
            "areal_gen_kv_utilization_ratio",
            "live KV tokens / allocated cache tokens, last chunk",
        )
        self._m_kv_live = reg.gauge("areal_gen_kv_live_tokens", "live KV tokens, last chunk")
        self._m_kv_alloc = reg.gauge(
            "areal_gen_kv_allocated_tokens",
            "allocated KV cache tokens, last chunk",
        )
        self._m_live_slots = reg.gauge(
            "areal_gen_live_slots", "slots live in the current chunk loop"
        )
        self.set_params(params)

    # ---------------- weights ----------------

    def set_params(self, params: Dict[str, Any]) -> None:
        """Place the weights on the engine's device, floats cast to the
        compute dtype.  Never aliases the source: `.to()` returns the
        same storage when device and dtype already match, and a
        TrainEngine's optimizer updates its masters in place — under a
        running generation, were they shared.  Such leaves are copied."""

        def place(x):
            if isinstance(x, dict):
                return {k: place(v) for k, v in x.items()}
            y = x.to(self.device)
            if y.is_floating_point():
                y = y.to(self.compute_dtype)
            if y.untyped_storage().data_ptr() == x.untyped_storage().data_ptr():
                y = y.clone()
            return y

        self.params = place(params)

    # ---------------- capacity (read by the server) ----------------

    @property
    def page_budget_tokens(self) -> Optional[int]:
        """Token capacity of an explicitly sized page pool (None when the
        pool is auto-sized)."""
        if self.kv_pool_pages == 0:
            return None
        return self.kv_pool_pages * self.kv_page_size

    def group_footprint_tokens(
        self, prompt_len: int, max_new_tokens: int, n: int
    ) -> int:
        """Worst-case pool footprint (tokens) of `n` same-prompt requests,
        CoW-aware: the prompt's full pages are paid once."""
        plen, mnew, n = int(prompt_len), int(max_new_tokens), int(n)
        if not self.kv_share_prefix or n <= 1:
            return n * (plen + mnew)
        sp = max(0, (plen - 1) // self.kv_page_size)
        return sp * self.kv_page_size + n * ((plen - sp * self.kv_page_size) + mnew)

    def _set_live_slots(self, n: int) -> None:
        self.live_slots = int(n)
        self.load_state = (int(n), self.kv_utilization)
        self._m_live_slots.set(n)

    # ---------------- interruption (async weight sync) ----------------

    def interrupt(self) -> None:
        """Ask the running generate() to park at its next chunk boundary.
        Safe from any thread."""
        self._interrupt_evt.set()

    def clear_interrupt(self) -> None:
        self._interrupt_evt.clear()

    @property
    def interrupted(self) -> bool:
        """True iff a parked session is waiting for resume_generate()."""
        return self._session is not None

    @property
    def interrupt_requested(self) -> bool:
        """True while an interrupt is pending (set, not yet cleared):
        episode drivers wait for it to clear before episode_resume()."""
        return self._interrupt_evt.is_set()

    # ---------------- generation ----------------

    @torch.no_grad()
    def generate(
        self,
        sample: SequenceSample,
        mb_spec: MicroBatchSpec,
        gconfig: GenerationHyperparameters,
        prompt_key: str = "packed_prompts",
        seed: int = 0,
        inflight: Optional[bool] = None,
    ) -> SequenceSample:
        """Group-sample `gconfig.n` responses per prompt, on the static
        path or the serving plane (module docstring): `inflight=True`
        asks for the serving plane, `False` for the static path, None
        leaves the choice to the engine; stop sequences always take the
        serving plane.

        Returns a SequenceSample (one element per prompt, `n` sequences
        per element) with packed_input_ids (prompt + response),
        packed_logprobs (seqlen-1 per sequence, behaviour logprobs on the
        response positions), prompt_mask and seq_no_eos_mask — or None
        when interrupt() parked the call (finish it with
        resume_generate())."""
        if self._session is not None:
            raise RuntimeError(
                "an interrupted generation is parked; call "
                "resume_generate() before starting a new one"
            )
        if gconfig.n < 1:
            raise ValueError(f"gconfig.n must be >= 1, got {gconfig.n}")
        self.prefill_dispatches = 0
        self.decode_compiles = 0
        self.cache_copy_bytes = 0
        self._chunk_fns = {}
        self.last_pool_stats = {}
        self.lanes_dispatched = 0
        self.lanes_live = 0
        self.lanes_slack = 0
        self.dead_live_lanes = 0
        # The goodput gauge's clock: the whole call, park time included.
        self._gen_t0 = time.monotonic()
        prompt_lens = sample.seqlens_of(prompt_key)
        bounds = sample.cu_seqlens(prompt_key)
        prompts = np.asarray(sample.data[prompt_key])
        n = gconfig.n
        # Expand xn and sort by length (desc).
        reqs = []  # (orig_idx, rep, tokens)
        for i in range(sample.bs):
            toks = prompts[bounds[i] : bounds[i + 1]]
            for r in range(n):
                reqs.append((i, r, toks))
        order = sorted(range(len(reqs)), key=lambda j: -len(reqs[j][2]))
        results: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray, bool]] = {}
        if gconfig.spec_decode_k > 0 or gconfig.stop:
            # Speculative decoding lives on the inflight paths; stop
            # sequences are matched on the host at chunk boundaries, and a
            # static program has none.
            inflight = True
        elif inflight is None:
            inflight = (
                len(reqs) > self.max_decode_batch
                or gconfig.max_new_tokens > self.static_path_max_new
            )
        # Uncategorized: the compute spans inside attribute the time.
        with tracer.span("generate", n_prompts=sample.bs, n_reqs=len(reqs),
                         inflight=bool(inflight)):
            if not inflight:
                generator = torch.Generator(device=self.device).manual_seed(int(seed))
                b_cap = self.max_decode_batch
                for start in range(0, len(order), b_cap):
                    chunk = [reqs[j] for j in order[start : start + b_cap]]
                    self._generate_chunk(chunk, gconfig, generator, results)
                return self._assemble(sample, prompt_key, prompt_lens, results, n)
            self._generate_inflight([reqs[j] for j in order], gconfig, seed, results)
        if self._session is not None:
            # Parked: stash the assembly context for resume_generate().
            st = self._session
            st.sample, st.prompt_key = sample, prompt_key
            st.prompt_lens, st.n = prompt_lens, n
            return None
        return self._assemble(sample, prompt_key, prompt_lens, results, n)

    @torch.no_grad()
    def resume_generate(self) -> Optional[SequenceSample]:
        """Continue a parked generate() under the engine's CURRENT
        weights.  Each live row's last chunk of forwarded tokens is
        replayed through its existing page table (its tail KV rewritten
        in place, its next-token logits refreshed), then the serving loop
        continues.  Returns the finished SequenceSample, or None if
        interrupted again."""
        st = self._session
        if st is None:
            raise RuntimeError("no interrupted generation to resume")
        self._session = None
        live = [s for s in range(st.n_slots) if st.active[s] is not None]
        if live:
            Q = st.chunk_t
            tokens = np.full((st.n_slots, Q), self.pad_token_id, np.int64)
            positions = np.zeros((st.n_slots, Q), np.int64)
            write_pos0 = np.zeros((st.n_slots,), np.int64)
            take_idx = np.zeros((st.n_slots,), np.int64)
            live_mask = np.zeros((st.n_slots,), bool)
            q_lens = np.zeros((st.n_slots,), np.int64)
            for s in live:
                hist = np.concatenate(
                    [st.slot_prompt[s], np.asarray(st.toks_acc[s], np.int32)]
                )
                # One KV per FORWARDED token: a decoding row has all of
                # hist in cache; a row parked mid-prefill only
                # hist[:cache_len] (the rest still waits in prompt_buf).
                L = int(st.cache_len[s])
                hl = hist[:L]
                # Replay the last chunk's emissions (>= 1, so the fresh
                # logits come from a real forward), never below the
                # slot's private region: shared prompt pages are
                # read-only.  Padding columns are dead queries.
                r = int(min(max(int(st.last_emit[s]), 1), Q, L - int(st.shared_from[s])))
                if r <= 0:
                    continue  # nothing private to replay
                tokens[s, :r] = hl[L - r :]
                write_pos0[s] = L - r
                positions[s] = (L - r) + np.arange(Q)
                take_idx[s] = r - 1
                live_mask[s] = True
                q_lens[s] = r
            to_dev = self._to_dev
            with tracer.span("resume_replay", cat="compute", n=len(live)):
                self._get_paged_replay_fn()(
                    self.params, to_dev(tokens), to_dev(positions), st.pool,
                    to_dev(st.alloc.table), to_dev(write_pos0), st.logits_buf,
                    to_dev(take_idx), to_dev(live_mask), to_dev(q_lens),
                )
            self.resume_replays += 1
        if st.prefill_chunk == 0:  # the two-program paged path
            finished = self._run_paged_loop(st)
        else:
            # The push invalidated every cached prompt KV: post-resume
            # admissions re-prefill under the new weights instead of
            # sharing stale pages.  Live followers keep their mappings
            # (their whole history KV is equally pre-push: the accepted
            # approximation of resuming), and a row live across the push
            # that later finishes its prefill must not publish its
            # mixed-weight prefix.
            st.alloc.prefix_clear()
            st.inflight_prefix.clear()
            st.slot_hash.clear()
            finished = self._run_serving_loop(st)
        if not finished:
            return None
        return self._assemble(
            st.sample, st.prompt_key, st.prompt_lens, st.results, st.n
        )

    def _get_paged_replay_fn(self):
        """Teacher-forced tail replay for resume: Q history tokens per
        row forwarded through the existing page table (KV overwritten in
        place), next-token logits taken at each live row's last valid
        query into the logits buffer (in place).  Rows without a replay
        have q_lens 0: their writes reach only the trash page and their
        logits rows are kept."""
        cfg = self.cfg

        def fn(params, tokens, positions, pool, page_table, write_pos0,
               logits_buf, take_idx, live_mask, q_lens):
            logits_all, _ = tfm.decode_step_spec_paged(
                params, cfg, tokens, positions, pool, page_table, write_pos0,
                q_lens=q_lens,
            )  # [B, Q, V]
            fresh = torch.gather(
                logits_all, 1,
                take_idx[:, None, None].expand(-1, 1, logits_all.shape[-1]),
            )[:, 0]
            logits_buf.copy_(torch.where(live_mask[:, None], fresh, logits_buf))

        return fn

    def _drain_chunk_outputs(
        self, out_toks, out_logps, new_done, active, toks_acc, logps_acc,
        results, done_host, cache_len, max_new: int, on_retire=None,
        stop_seqs=(),
    ) -> None:
        """Append each live slot's chunk output (rows are contiguous,
        -1-terminated), finish on EOS, a matched stop sequence (the stop
        tokens stay in the output) or the token budget, and retire
        finished slots (`on_retire(slot)` recycles their pages)."""
        for s in range(len(active)):
            if active[s] is None:
                continue
            row = out_toks[s]
            stop = np.flatnonzero(row < 0)  # -1-terminated within the chunk
            limit = int(stop[0]) if stop.size else row.shape[0]
            limit = min(limit, max(0, max_new - len(toks_acc[s])))
            eos = np.flatnonzero(row[:limit] == self.eos_token_id)
            if eos.size:  # keep the EOS token itself, drop the tail
                limit = int(eos[0]) + 1
            prev_len = len(toks_acc[s])
            toks_acc[s].extend(row[:limit].tolist())
            logps_acc[s].extend(out_logps[s, :limit].tolist())
            cut = (
                _find_stop_end(toks_acc[s], prev_len, stop_seqs)
                if stop_seqs
                else None
            )
            if cut is not None:
                del toks_acc[s][cut:]
                del logps_acc[s][cut:]
            finished = (
                cut is not None
                or len(toks_acc[s]) >= max_new
                or (toks_acc[s] and toks_acc[s][-1] == self.eos_token_id)
            )
            if finished:
                i, rep = active[s]
                gtoks = np.asarray(toks_acc[s], np.int32)
                glogps = np.asarray(logps_acc[s], np.float32)
                no_eos = not (len(gtoks) and gtoks[-1] == self.eos_token_id)
                results[(i, rep)] = (gtoks, glogps, no_eos)
                active[s] = None
                done_host[s] = True
                cache_len[s] = 0
                if on_retire is not None:
                    on_retire(s)
            else:
                done_host[s] = new_done[s]

    def _accum_pool_stats(
        self, kind: str, live_tokens: int, allocated_tokens: int
    ) -> None:
        """Accumulate per-chunk KV utilization (live tokens / allocated
        cache tokens) into last_pool_stats."""
        st = self.last_pool_stats
        if st.get("kind") != kind:
            st.clear()
            st.update(kind=kind, samples=0, live_tokens=0, allocated_tokens=0)
        st["samples"] += 1
        st["live_tokens"] += int(live_tokens)
        st["allocated_tokens"] += int(allocated_tokens)
        st["utilization"] = st["live_tokens"] / max(st["allocated_tokens"], 1)
        self.kv_utilization = int(live_tokens) / max(int(allocated_tokens), 1)
        self.load_state = (self.live_slots, self.kv_utilization)
        self._m_kv_util.set(self.kv_utilization)
        self._m_kv_live.set(int(live_tokens))
        self._m_kv_alloc.set(int(allocated_tokens))
        # KV pool pressure over time, a sample a chunk.
        tracer.counter("kv_pool", live_tokens=int(live_tokens),
                       allocated_tokens=int(allocated_tokens),
                       utilization=self.kv_utilization)

    # -- the unified serving plane --

    def _generate_inflight_serving(self, reqs, gconfig, seed, results) -> None:
        n_slots = min(self.max_decode_batch, len(reqs))
        ps = self.kv_page_size
        chunk_t = min(32, gconfig.max_new_tokens)
        K = gconfig.spec_decode_k
        max_prompt = max(len(t) for (_, _, t) in reqs)
        # A speculating row writes up to K draft positions past its chunk.
        max_pages = -(-(max_prompt + gconfig.max_new_tokens + chunk_t + K) // ps)
        n_pages = self.kv_pool_pages or n_slots * max_pages
        pbw = max(max_prompt, 1)
        buf_w = max_prompt + gconfig.max_new_tokens + K + 2
        dev = self.device
        st = _PagedGenSession(
            gconfig=gconfig,
            generator=torch.Generator(device=dev).manual_seed(int(seed)),
            results=results,
            n_slots=n_slots,
            n_pages=n_pages,
            max_pages=max_pages,
            chunk_t=chunk_t,
            alloc=PageAllocator(n_pages, ps, n_slots, max_pages),
            pool=tfm.init_paged_kv_cache(
                self.cfg, n_pages, ps, dtype=self._kv_dtype(), device=dev
            ),
            logits_buf=torch.zeros(
                (n_slots, self.cfg.vocab_size), dtype=torch.float32, device=dev
            ),
            cache_len=np.zeros((n_slots,), np.int32),
            gen_count=np.zeros((n_slots,), np.int32),
            done_host=np.ones((n_slots,), bool),
            active=[None] * n_slots,
            toks_acc={},
            logps_acc={},
            pending=list(reversed(reqs)),
            slot_prompt={},
            last_emit=np.zeros((n_slots,), np.int32),
            prefill_chunk=self.prefill_chunk_tokens,
            prompt_buf=np.full((n_slots, pbw), self.pad_token_id, np.int32),
            prefill_rem=np.zeros((n_slots,), np.int32),
            prompt_off=np.zeros((n_slots,), np.int32),
            shared_from=np.zeros((n_slots,), np.int32),
            slot_hash={},
            inflight_prefix={},
            tokens_buf=torch.zeros((n_slots, buf_w + K + 1), dtype=torch.long, device=dev),
            pending_tok=torch.zeros((n_slots,), dtype=torch.long, device=dev),
        )
        # Bytes per page, the trash page excluded from the pool's count.
        st.alloc.page_bytes = st.pool.nbytes() // (n_pages + 1)
        self._run_serving_loop(st)

    def _run_serving_loop(self, st: _PagedGenSession) -> bool:
        """Every iteration admits into free slots (host bookkeeping only),
        maps pages for the chunk's worst-case advance, privatises any
        shared page a write could touch, then runs ONE serving chunk in
        which prefilling rows consume up to W prompt tokens per inner step
        while decoding rows emit one token.  Interruptible at the top of
        each iteration: returns False parked (the session waits in
        `_session`), True finished."""
        gconfig = st.gconfig
        alloc = st.alloc
        n_slots, ps, chunk_t = st.n_slots, alloc.page_size, st.chunk_t
        W = st.prefill_chunk
        pbw = st.prompt_buf.shape[1]
        chunk_fn = self._get_serving_chunk_fn(
            n_slots, st.n_pages, st.max_pages, chunk_t, W, pbw, gconfig
        )
        to_dev = self._to_dev
        while st.pending or any(a is not None for a in st.active):
            if self._interrupt_evt.is_set():
                self._session = st
                self._count_interrupt(st)
                return False
            self._take_admits_serving(st)
            # Map pages covering this chunk's worst-case advance per live
            # slot: a prefilling row consumes up to chunk_t*Wmax prompt
            # tokens (never more than its remainder + the decode steps
            # after it); a decoding row advances at most chunk_t (plain)
            # or chunk_t*(K+1) (spec), clamped to its remaining budget + K
            # draft positions (over-budget writes go to the trash page
            # and their tokens are drained away).
            max_new = gconfig.max_new_tokens
            K = gconfig.spec_decode_k
            Wmax = max(W, K + 1)
            for s in range(n_slots):
                if st.active[s] is not None:
                    rem = int(st.prefill_rem[s])
                    left = max(0, max_new - int(st.gen_count[s]))
                    target = int(st.cache_len[s]) + max(
                        1, min(chunk_t * Wmax, rem + chunk_t * (K + 1), rem + left + K)
                    )
                    self._reserve_with_evict(alloc, s, target)
            self._privatize_write_windows(st)
            self._accum_pool_stats(
                "paged", int(st.cache_len.sum()), alloc.allocated_pages() * ps
            )
            prev_gen = st.gen_count.copy()
            prev_rem = st.prefill_rem.copy()
            # Admission prefill rides the chunk: one compute span covers
            # both, and ends at the chunk's host read.
            with tracer.span("serving_chunk", cat="compute", t=chunk_t, w=W):
                (
                    out_toks, out_logps, new_cache_len, new_gen_count, new_done,
                    new_rem, new_off, lane_acc,
                ) = chunk_fn(
                    self.params, st.pool, st.logits_buf,
                    to_dev(alloc.table), to_dev(st.prompt_buf.astype(np.int64)),
                    to_dev(st.prompt_off.astype(np.int64)),
                    to_dev(st.prefill_rem.astype(np.int64)),
                    to_dev(st.cache_len.astype(np.int64)),
                    to_dev(st.gen_count.astype(np.int64)),
                    to_dev(st.done_host), st.tokens_buf, st.pending_tok, st.generator,
                )
                # The chunk's one host sync: the done/eos flags must be
                # exact before the next admission round.
                out_toks = out_toks.cpu().numpy()
                out_logps = out_logps.cpu().numpy()
                lane_acc = lane_acc.cpu().numpy()
                new_done = new_done.cpu().numpy()
                st.cache_len = new_cache_len.cpu().numpy().astype(np.int32)
                st.gen_count = new_gen_count.cpu().numpy().astype(np.int32)
                st.prefill_rem = new_rem.cpu().numpy().astype(np.int32)
                st.prompt_off = new_off.cpu().numpy().astype(np.int32)
            st.last_emit = st.gen_count - prev_gen
            self.steps_total += chunk_t
            self.lanes_dispatched += chunk_t * self.serving_lane_budget
            self.lanes_live += int(lane_acc[0])
            self.lanes_slack += int(lane_acc[1])
            self.dead_live_lanes += int(lane_acc[2])

            # Register prefixes that FINISHED prefilling this chunk before
            # any retirement can release the owner's pages.
            if self.kv_share_prefix:
                for s in range(n_slots):
                    if (
                        st.active[s] is not None
                        and prev_rem[s] > 0
                        and st.prefill_rem[s] == 0
                    ):
                        self._register_prefix(st, s)

            def _retire(s):
                alloc.release(s)
                st.slot_prompt.pop(s, None)
                h = st.slot_hash.pop(s, None)
                if h is not None and st.inflight_prefix.get(h) == s:
                    del st.inflight_prefix[h]

            self._drain_chunk_outputs(
                out_toks, out_logps, new_done, st.active,
                st.toks_acc, st.logps_acc, st.results, st.done_host,
                st.cache_len, gconfig.max_new_tokens, on_retire=_retire,
                stop_seqs=gconfig.stop,
            )
        self.last_pool_stats.update(
            pool_pages=st.n_pages, page_size=ps,
            pages_recycled=alloc.pages_recycled,
            peak_pages_used=alloc.peak_pages_used,
            cow_copies=alloc.cow_copies,
            shared_mappings=alloc.shared_mappings,
            prefix_hits=alloc.prefix_hits,
            prefix_misses=alloc.prefix_misses,
            peak_live_slots=st.peak_live,
            pool_bytes=alloc.pool_bytes(),
            peak_allocated_bytes=alloc.peak_pages_used * alloc.page_bytes,
        )
        self._set_live_slots(0)
        return True

    def _take_admits_serving(self, st: _PagedGenSession) -> int:
        """Admission: pure host bookkeeping (the chunk does the prompt
        forwards).  A request whose prompt hash is in the prefix cache
        maps the cached FULL prompt pages and re-forwards only the
        sub-page tail; a request whose hash an in-flight owner is still
        prefilling WAITS (the owner is live, so waiting cannot deadlock).
        Raises PagePoolExhausted via reserve() when nothing is live and
        the head request still cannot fit."""
        alloc, gconfig = st.alloc, st.gconfig
        n_slots, ps, chunk_t = st.n_slots, alloc.page_size, st.chunk_t
        # A speculating row may write K draft positions past its chunk.
        slack = chunk_t + gconfig.spec_decode_k
        admitted = 0
        for s in range(n_slots):
            if st.active[s] is not None or not st.pending:
                continue
            i, rep, toks = st.pending[-1]
            toks = np.asarray(toks, np.int32)
            plen = len(toks)
            # Only FULL pages are shareable, and the tail keeps >= 1 token
            # so the follower's re-forward produces its own end-of-prompt
            # logits: sp = (plen-1)//ps pages cover [0, sp*ps).
            sp = (plen - 1) // ps
            h = toks.tobytes() if (self.kv_share_prefix and sp > 0) else None
            shared = alloc.prefix_lookup(h) if h is not None else None
            if shared is None and h is not None and h in st.inflight_prefix:
                break  # wait one chunk for the owner to register
            if shared is not None:
                need = alloc.pages_for(plen + slack) - len(shared)
                if need > len(alloc.free):
                    alloc.prefix_evict(need)
                if need > len(alloc.free):
                    break
                alloc.share(s, shared)
                start = sp * ps
                alloc.reserve(s, plen + slack)
            else:
                if not alloc.can_reserve(s, plen + slack):
                    alloc.prefix_evict(
                        alloc.pages_for(plen + slack) - int(alloc.used[s])
                    )
                if not alloc.can_reserve(s, plen + slack):
                    break
                alloc.reserve(s, plen + slack)
                start = 0
                if h is not None:
                    st.inflight_prefix[h] = s
                    st.slot_hash[s] = h
            st.pending.pop()
            st.active[s] = (i, rep)
            st.cache_len[s] = start
            st.gen_count[s] = 0
            st.done_host[s] = False
            st.toks_acc[s] = []
            st.logps_acc[s] = []
            st.slot_prompt[s] = toks
            st.shared_from[s] = start
            st.last_emit[s] = 0
            rem = plen - start
            st.prompt_buf[s, :] = self.pad_token_id
            st.prompt_buf[s, :rem] = toks[start:]
            st.prefill_rem[s] = rem
            st.prompt_off[s] = 0
            admitted += 1
        if (
            admitted == 0
            and st.pending
            and not any(a is not None for a in st.active)
        ):
            # Nothing live to retire and the head request does not fit:
            # reserve() raises the clean capacity error.
            free_slot = next(
                s2 for s2 in range(n_slots) if st.active[s2] is None
            )
            alloc.reserve(free_slot, len(st.pending[-1][2]) + slack)
        self._set_live_slots(sum(a is not None for a in st.active))
        st.peak_live = max(st.peak_live, self.live_slots)
        tracer.counter("gen_slots", live=self.live_slots, pending=len(st.pending))
        return admitted

    def _count_interrupt(self, st: _PagedGenSession) -> None:
        tracer.counter("gen_interrupt",
                       parked_live=sum(a is not None for a in st.active),
                       parked_pending=len(st.pending))

    def _register_prefix(self, st: _PagedGenSession, s: int) -> None:
        """Publish owner slot `s`'s full prompt pages in the prefix cache
        now that its prefill is complete; a no-op for followers."""
        h = st.slot_hash.get(s)
        if h is None:
            return
        alloc = st.alloc
        sp = (len(st.slot_prompt[s]) - 1) // alloc.page_size
        if sp > 0:
            alloc.prefix_insert(h, alloc.table[s, :sp])
        st.inflight_prefix.pop(h, None)
        del st.slot_hash[s]

    def _reserve_with_evict(
        self, alloc: PageAllocator, s: int, tokens: int
    ) -> None:
        """reserve() that first evicts LRU prefix-cache holds when the
        free list is short — a live slot's growth outranks cached
        prefixes."""
        if not alloc.can_reserve(s, tokens):
            alloc.prefix_evict(alloc.pages_for(tokens) - int(alloc.used[s]))
        alloc.reserve(s, tokens)

    def _privatize_write_windows(self, st: _PagedGenSession) -> None:
        """Copy-on-write safety net before every chunk: privatise any
        SHARED page inside a live row's write window [cache_len,
        used*page_size) and copy those pages on the device (eager
        `copy_pages`, 16 pairs per call, sentinel-padded).  The serving
        plane never maps a shared page at or past a write cursor, so the
        steady state is zero pairs."""
        alloc = st.alloc
        pairs: List[Tuple[int, int]] = []
        for s in range(st.n_slots):
            if st.active[s] is None:
                continue
            pairs.extend(
                alloc.ensure_writable(
                    s, int(st.cache_len[s]), int(alloc.used[s]) * alloc.page_size
                )
            )
        width = 16
        for lo in range(0, len(pairs), width):
            src = np.full((width,), alloc.sentinel, np.int64)
            dst = np.full((width,), alloc.sentinel, np.int64)
            for j, (a, b) in enumerate(pairs[lo : lo + width]):
                src[j], dst[j] = a, b
            tfm.copy_pages(
                st.pool,
                torch.from_numpy(src).to(self.device),
                torch.from_numpy(dst).to(self.device),
            )

    def _get_serving_chunk_fn(
        self, n_slots: int, n_pages: int, max_pages: int, chunk_t: int,
        W: int, pbw: int, g: GenerationHyperparameters,
    ):
        """The serving chunk over a PACKED ragged token stream: chunk_t
        inner steps, each ONE `decode_step_ragged_paged` forward of a
        [T]-lane stream in which every row occupies exactly the lanes it
        needs — a prefilling row up to W prompt tokens, a decoding row its
        1 sampled token (K+1 with spec_decode_k = K: its pending token and
        K n-gram drafts), a done row zero.  Dead lanes are eliminated, not
        masked: the stream ends at `total` live lanes and the slack tail
        carries rows >= n_slots whose attention runs no page.

        Lane budget: T = min(n_slots + A, n_slots * Wmax), Wmax = max(W,
        K+1), A the admit-lane headroom (0 = auto, 4 * Wmax).  Every live
        row gets >= 1 lane; rows wanting more split the spare lanes front
        to back, and a speculating row granted c < K+1 lanes verifies only
        its first c - 1 drafts (`spec_accept`'s n_valid).

        Everything inside runs on the device: there is no host sync
        between the inner steps.  The pool, the logits buffer and (spec)
        the history buffer and pending tokens are updated in place.  One
        build per loop (`decode_compiles`).  Emission is fill-indexed: a
        row's tokens pack from column 0 of its out row whatever steps it
        spent prefilling (-1-terminated)."""
        K = g.spec_decode_k
        Wmax = max(W, K + 1)
        A = self.serving_admit_lanes or 4 * Wmax
        T = min(n_slots + A, n_slots * Wmax)
        self.serving_lane_budget = T
        cfg = self.cfg
        eos = self.eos_token_id
        dev = self.device
        # A spec row emits up to K+1 tokens per inner step, plus one fresh
        # first token the step it leaves prefill; K+1 scratch columns past
        # out_w take the writes of emissions past a row's count.
        out_w = chunk_t * (K + 1) + 1 if K > 0 else chunk_t

        def fn(params, pool, logits, page_table, prompt_buf, prompt_off,
               prefill_rem, cache_len, gen_count, done, tokens_buf, pending_buf,
               generator):
            out_toks = torch.full((n_slots, out_w + K + 1), -1, dtype=torch.long, device=dev)
            out_logps = torch.zeros((n_slots, out_w + K + 1), dtype=torch.float32, device=dev)
            out_fill = torch.zeros((n_slots,), dtype=torch.long, device=dev)
            # (live lanes, slack lanes, live-but-misassigned lanes).
            lane_acc = torch.zeros((3,), dtype=torch.long, device=dev)
            rows = torch.arange(n_slots, device=dev)
            lanes = torch.arange(Wmax, device=dev)
            lane_ids = torch.arange(T, device=dev)
            zero = torch.zeros((), dtype=torch.long, device=dev)
            layers = tfm.layer_views(params)
            if g.min_new_tokens > 0:
                eos_col = torch.arange(cfg.vocab_size, device=dev) == eos
            if K > 0:
                buf_w = tokens_buf.shape[1] - (K + 1)
                pending = pending_buf
            for _ in range(chunk_t):
                is_pref = prefill_rem > 0
                lg = logits
                if g.min_new_tokens > 0:
                    lg = lg.masked_fill(
                        (gen_count < g.min_new_tokens)[:, None] & eos_col[None, :],
                        -1e10,
                    )
                tok, logp = sample_token(
                    lg, generator,
                    temperature=g.temperature, top_k=g.top_k, top_p=g.top_p,
                    greedy=g.greedy,
                )
                if K > 0:
                    # The carried sample only seeds rows fresh out of
                    # prefill (their first pending token, emitted now);
                    # speculating rows emit through spec_accept below.
                    emitting = (~done) & (~is_pref) & (gen_count == 0)
                else:
                    emitting = (~done) & (~is_pref)
                out_toks[rows, out_fill] = torch.where(
                    emitting, tok, out_toks[rows, out_fill]
                )
                out_logps[rows, out_fill] = torch.where(
                    emitting, logp, out_logps[rows, out_fill]
                )
                out_fill = out_fill + emitting.long()
                if K > 0:
                    done = done | (emitting & (tok == eos))
                    gen_count = gen_count + emitting.long()
                    pending = torch.where(emitting, tok, pending)
                    # A speculating row keeps cache_len = plen + gen_count
                    # - 1, with its pending token at tokens_buf[cache_len].
                    bp0 = torch.clamp(cache_len, 0, buf_w - 1)
                    tokens_buf[rows, bp0] = torch.where(emitting, tok, tokens_buf[rows, bp0])
                    drafts = propose_ngram(
                        tokens_buf[:, :buf_w], cache_len + 1, K, g.spec_ngram
                    )  # [n_slots, K]
                # Per-row lane want: done rows 0, prefilling rows their
                # next W-slice, decoding rows K+1.  Everybody gets a base
                # lane (T >= n_slots); the spare splits front to back.
                want = torch.where(
                    done, zero,
                    torch.where(
                        is_pref, torch.clamp(prefill_rem, max=W), zero + K + 1
                    ),
                )
                base = (want > 0).long()
                extra = want - base
                spare = T - base.sum()
                excl = torch.cumsum(extra, 0) - extra
                c = base + torch.minimum(torch.clamp(spare - excl, min=0), extra)
                c = torch.where(want > 0, c, zero)
                # Pack: row r owns stream lanes [starts[r], starts[r]+c[r]).
                cu = torch.cumsum(c, 0)
                starts = cu - c
                total = cu[-1]
                row_of = torch.searchsorted(cu, lane_ids, right=True)
                lane_live = lane_ids < total
                rid = torch.clamp(row_of, max=n_slots - 1)
                qpos = lane_ids - starts[rid]
                badlane = lane_live & (
                    (row_of >= n_slots) | (qpos < 0) | (qpos >= c[rid])
                )
                lane_acc += torch.stack([total, T - total, badlane.sum()])
                # Per-row lane-token slab, gathered into the stream.
                idx = torch.clamp(prompt_off[:, None] + lanes[None, :], max=pbw - 1)
                pref_toks = torch.gather(prompt_buf, 1, idx)
                if K > 0:
                    dec = torch.cat([pending[:, None], drafts], dim=1)
                    if Wmax > K + 1:
                        dec = torch.nn.functional.pad(dec, (0, Wmax - (K + 1)))
                    slab = torch.where(is_pref[:, None], pref_toks, dec)
                    # Prefilling rows record their granted prompt slice in
                    # the history buffer (the n-gram proposer reads it).
                    lv = is_pref[:, None] & (lanes[None, :] < c[:, None])
                    bcols = torch.clamp(cache_len[:, None] + lanes[None, :], 0, buf_w - 1)
                    tokens_buf[rows[:, None], bcols] = torch.where(
                        lv, pref_toks, tokens_buf[rows[:, None], bcols]
                    )
                else:
                    slab = torch.where(is_pref[:, None], pref_toks, zero)
                    slab[:, 0] = torch.where(is_pref, pref_toks[:, 0], tok)
                qv = torch.clamp(qpos, 0, Wmax - 1)
                stream_tok = torch.where(lane_live, slab[rid, qv], zero)
                stream_pos = torch.where(lane_live, cache_len[rid] + qv, zero)
                logits_pk, _ = tfm.decode_step_ragged_paged(
                    params, cfg, stream_tok, stream_pos, pool, page_table, row_of,
                    layers=layers,
                )  # [T, V]
                # Next-step carry = each granted row's LAST lane logits;
                # zero-lane rows keep theirs.
                last = torch.clamp(starts + c - 1, 0, T - 1)
                logits.copy_(torch.where((c > 0)[:, None], logits_pk[last], logits))
                if K > 0:
                    # Row r's K+1 spec positions are lanes starts[r] ..
                    # starts[r] + K, of which the first c[r] were forwarded.
                    gidx = torch.clamp(
                        starts[:, None] + torch.arange(K + 1, device=dev)[None, :],
                        0, T - 1,
                    )
                    active = (~done) & (~is_pref) & (c > 0)
                    pending, cache_len_s, gen_count, done, out_fill = _spec_emit(
                        cfg, g, eos, rows, logits_pk[gidx], drafts, generator,
                        pending, cache_len, gen_count, done, out_toks, out_logps,
                        out_fill, out_w, tokens_buf, buf_w, active=active, n_valid=c,
                    )
                    cache_len = torch.where(is_pref, cache_len + c, cache_len_s)
                else:
                    done = torch.where(is_pref, done, done | (tok == eos))
                    # Decode rows advance by their emission (a row emitting
                    # its EOS still wrote that token); done rows stay put.
                    cache_len = cache_len + c
                    gen_count = gen_count + emitting.long()
                adv = torch.where(is_pref, c, zero)
                prompt_off = prompt_off + adv
                prefill_rem = prefill_rem - adv
            if K > 0:
                pending_buf.copy_(pending)
            return (
                out_toks[:, :out_w], out_logps[:, :out_w], cache_len, gen_count,
                done, prefill_rem, prompt_off, lane_acc,
            )

        self.decode_compiles += 1
        self._m_decode_compiles.inc()
        return fn

    # -- agent episodes (multi-turn tool use on parked KV pages) --

    def _require_serving_plane(self) -> None:
        if not (self.kv_paged and self.prefill_chunk_tokens > 0):
            raise RuntimeError(
                "episodes require the serving plane: kv_paged=True and "
                "prefill_chunk_tokens > 0"
            )

    def _episode_session_get(
        self, gconfig: GenerationHyperparameters, token_budget: int, seed: int
    ) -> _PagedGenSession:
        """The engine-lifetime episode session (one slot pool and one
        page pool shared by every live episode), made at first use.  The
        first episode fixes its geometry, so the serving chunk is built
        once for a whole multi-episode run (`decode_compiles`)."""
        if self._ep_session is not None:
            return self._ep_session
        n_slots = self.max_decode_batch
        ps = self.kv_page_size
        chunk_t = min(32, gconfig.max_new_tokens)
        budget = int(token_budget) or 2048
        # The admission width bounds any one teacher-forced slab; a
        # re-admission after SlotGone is the widest (the whole budget).
        pbw = budget
        K = gconfig.spec_decode_k
        max_pages = -(-(budget + chunk_t + K) // ps)
        n_pages = self.kv_pool_pages or n_slots * max_pages
        dev = self.device
        st = _PagedGenSession(
            gconfig=gconfig,
            generator=torch.Generator(device=dev).manual_seed(int(seed)),
            results={},
            n_slots=n_slots,
            n_pages=n_pages,
            max_pages=max_pages,
            chunk_t=chunk_t,
            alloc=PageAllocator(n_pages, ps, n_slots, max_pages),
            pool=tfm.init_paged_kv_cache(
                self.cfg, n_pages, ps, dtype=self._kv_dtype(), device=dev
            ),
            logits_buf=torch.zeros(
                (n_slots, self.cfg.vocab_size), dtype=torch.float32, device=dev
            ),
            cache_len=np.zeros((n_slots,), np.int32),
            gen_count=np.zeros((n_slots,), np.int32),
            done_host=np.ones((n_slots,), bool),
            active=[None] * n_slots,
            toks_acc={},
            logps_acc={},
            pending=[],
            slot_prompt={},
            last_emit=np.zeros((n_slots,), np.int32),
            prefill_chunk=max(1, self.prefill_chunk_tokens),
            prompt_buf=np.full((n_slots, pbw), self.pad_token_id, np.int32),
            prefill_rem=np.zeros((n_slots,), np.int32),
            prompt_off=np.zeros((n_slots,), np.int32),
            shared_from=np.zeros((n_slots,), np.int32),
            slot_hash={},
            inflight_prefix={},
            # The history buffer's logical width is the JAX engine's,
            # budget + K + 2, plus the K + 1 scratch columns.
            tokens_buf=torch.zeros(
                (n_slots, budget + 2 * K + 3), dtype=torch.long, device=dev
            ),
            pending_tok=torch.zeros((n_slots,), dtype=torch.long, device=dev),
            episodes={},
            ep_budget=budget,
            chunk_fns={},
        )
        st.alloc.page_bytes = st.pool.nbytes() // (n_pages + 1)
        self._ep_session = st
        return st

    @torch.no_grad()
    def episode_start(
        self, ep_id: str, prompt_ids, gconfig: GenerationHyperparameters,
        token_budget: int = 0, seed: int = 0,
    ) -> Optional[Dict[str, Any]]:
        """Open an episode: pin a serving slot, admit the conversation
        through the serving chunk (the longest page-aligned transcript
        prefix already published rides the prefix cache: shared system
        prompts and re-admissions after SlotGone both land here), decode
        turn 0 until a stop sequence, EOS or a budget, then park the slot
        with its KV pages held.  Returns the turn dict, or None when an
        interrupt parked the call mid-turn (episode_resume() goes on)."""
        self._require_serving_plane()
        st = self._episode_session_get(gconfig, token_budget, seed)
        if ep_id in st.episodes:
            raise ValueError(f"episode {ep_id!r} already live")
        toks = np.asarray([int(t) for t in prompt_ids], np.int32)
        budget = int(token_budget) or st.ep_budget
        if len(toks) == 0:
            raise ValueError("episode_start needs a non-empty prompt")
        if len(toks) + 1 > budget:
            raise ValueError(
                f"episode prompt ({len(toks)} tokens) leaves no room in the "
                f"token budget ({budget})"
            )
        if len(toks) > st.prompt_buf.shape[1]:
            raise ValueError(
                f"episode prompt ({len(toks)} tokens) exceeds the admission "
                f"width ({st.prompt_buf.shape[1]})"
            )
        s = self._episode_free_slot(st)
        ep = _EpisodeSlot(ep_id=ep_id, slot=s, gconfig=gconfig, token_budget=budget)
        st.episodes[ep_id] = ep
        self.episodes_started += 1
        self._episode_admit(st, ep, toks, fresh=True)
        return self._run_episode_turn(st, ep)

    @torch.no_grad()
    def episode_extend(self, ep_id: str, obs_ids) -> Optional[Dict[str, Any]]:
        """Append a tool result onto the episode's SAME slot (a
        chunked-prefill admission over its live pages: nothing in cache
        is forwarded again) and decode the next turn.  Raises
        SlotGoneError when the slot was reclaimed; the controller then
        re-admits the full conversation through episode_start."""
        st = self._ep_session
        if st is None or ep_id not in st.episodes:
            raise SlotGoneError(
                ep_id, "engine has no episode session" if st is None else "slot reclaimed"
            )
        ep = st.episodes[ep_id]
        if ep.parked_mid_turn:
            raise RuntimeError(
                f"episode {ep_id!r} is parked mid-turn; call episode_resume() first"
            )
        obs = np.asarray([int(t) for t in obs_ids], np.int32)
        if len(obs) == 0:
            raise ValueError("episode_extend needs a non-empty observation")
        if len(obs) > st.prompt_buf.shape[1]:
            raise ValueError(
                f"observation ({len(obs)} tokens) exceeds the admission width "
                f"({st.prompt_buf.shape[1]})"
            )
        if ep.token_budget and int(st.cache_len[ep.slot]) + len(obs) + 1 > ep.token_budget:
            # The observation alone busts the budget: a terminal
            # zero-token turn and no admission (the slot keeps its pages
            # until release).
            ep.turns += 1
            return {
                "episode_id": ep.ep_id,
                "turn_index": ep.turns - 1,
                "tokens": [],
                "logprobs": [],
                "stop_reason": "budget",
                "transcript_len": int(st.cache_len[ep.slot]),
                "prefill_tokens": 0,
                "shared_prefix_tokens": int(st.shared_from[ep.slot]),
                "slot": ep.slot,
            }
        self._episode_admit(st, ep, obs, fresh=False)
        return self._run_episode_turn(st, ep)

    @torch.no_grad()
    def episode_resume(self, ep_id: str) -> Optional[Dict[str, Any]]:
        """Continue a mid-turn-parked episode under the CURRENT weights:
        replay the slot's last chunk tail through its page table (K3,
        one live row of resume_generate's replay), drop the prefix cache
        (KV of the old weights must not be shared into new admissions),
        then go on with the turn.  `resume_replays` counts the replays
        that ran."""
        st = self._ep_session
        if st is None or ep_id not in st.episodes:
            raise SlotGoneError(
                ep_id, "engine has no episode session" if st is None else "slot reclaimed"
            )
        ep = st.episodes[ep_id]
        if not ep.parked_mid_turn:
            raise RuntimeError(f"episode {ep_id!r} is not parked mid-turn")
        ep.parked_mid_turn = False
        s = ep.slot
        Q = st.chunk_t
        hist = np.concatenate([st.slot_prompt[s], np.asarray(st.toks_acc[s], np.int32)])
        L = int(st.cache_len[s])
        r = int(min(max(int(st.last_emit[s]), 1), Q, L - int(st.shared_from[s])))
        if r > 0:
            tokens = np.full((st.n_slots, Q), self.pad_token_id, np.int64)
            positions = np.zeros((st.n_slots, Q), np.int64)
            write_pos0 = np.zeros((st.n_slots,), np.int64)
            take_idx = np.zeros((st.n_slots,), np.int64)
            live_mask = np.zeros((st.n_slots,), bool)
            q_lens = np.zeros((st.n_slots,), np.int64)
            tokens[s, :r] = hist[L - r : L]
            write_pos0[s] = L - r
            positions[s] = (L - r) + np.arange(Q)
            take_idx[s] = r - 1
            live_mask[s] = True
            q_lens[s] = r
            to_dev = self._to_dev
            with tracer.span("episode_resume_replay", cat="compute", n=1):
                self._get_paged_replay_fn()(
                    self.params, to_dev(tokens), to_dev(positions), st.pool,
                    to_dev(st.alloc.table), to_dev(write_pos0), st.logits_buf,
                    to_dev(take_idx), to_dev(live_mask), to_dev(q_lens),
                )
            self.resume_replays += 1
        st.alloc.prefix_clear()
        st.inflight_prefix.clear()
        st.slot_hash.clear()
        return self._run_episode_turn(st, ep)

    def episode_release(self, ep_id: str) -> bool:
        """Retire an episode: release its pages (prefix-cache holds on its
        published transcript prefixes survive) and free the slot.  False
        when the episode is already gone."""
        st = self._ep_session
        if st is None or ep_id not in st.episodes:
            return False
        self._drop_episode(st, st.episodes[ep_id])
        return True

    def episode_stats(self) -> Dict[str, Any]:
        """The episode plane's load and counters."""
        st = self._ep_session
        out = {
            "active": 0,
            "parked_mid_turn": 0,
            "started": self.episodes_started,
            "evicted": self.episodes_evicted,
            "prefix_hits": self.episode_prefix_hits,
            "prefix_misses": self.episode_prefix_misses,
        }
        if st is not None:
            out["active"] = len(st.episodes)
            out["parked_mid_turn"] = sum(e.parked_mid_turn for e in st.episodes.values())
            out["pool_pages"] = st.n_pages
            out["pages_allocated"] = st.alloc.allocated_pages()
        return out

    def _episode_free_slot(self, st: _PagedGenSession) -> int:
        for s in range(st.n_slots):
            if st.active[s] is None:
                return s
        # Every slot is pinned: reclaim the least recently admitted
        # parked episode; its controller gets SlotGoneError next time and
        # re-admits through the prefix cache.
        if not self._evict_parked_episode(st):
            raise RuntimeError("no free episode slot and nothing parked to evict")
        return next(s for s in range(st.n_slots) if st.active[s] is None)

    def _evict_parked_episode(self, st: _PagedGenSession, exclude: str = "") -> bool:
        """Reclaim the LRU parked episode's slot and pages.  Episodes
        parked mid-turn are exempt: their resume owns the slot."""
        cands = [
            ep for ep in st.episodes.values()
            if not ep.parked_mid_turn and ep.ep_id != exclude
        ]
        if not cands:
            return False
        self._drop_episode(st, min(cands, key=lambda e: e.seq))
        self.episodes_evicted += 1
        return True

    def _drop_episode(self, st: _PagedGenSession, ep: _EpisodeSlot) -> None:
        s = ep.slot
        st.alloc.release(s)
        st.active[s] = None
        st.done_host[s] = True
        st.cache_len[s] = 0
        st.gen_count[s] = 0
        st.prefill_rem[s] = 0
        st.prompt_off[s] = 0
        st.last_emit[s] = 0
        st.shared_from[s] = 0
        st.slot_prompt.pop(s, None)
        st.toks_acc.pop(s, None)
        st.logps_acc.pop(s, None)
        st.episodes.pop(ep.ep_id, None)

    def _reserve_or_evict_parked(self, st: _PagedGenSession, ep: _EpisodeSlot,
                                 tokens: int) -> None:
        """reserve() for an episode's slot; when the pool is short even
        after the prefix cache gave way, evict the LRU parked episode
        and try once more."""
        try:
            self._reserve_with_evict(st.alloc, ep.slot, tokens)
        except PagePoolExhausted:
            if not self._evict_parked_episode(st, exclude=ep.ep_id):
                raise
            self._reserve_with_evict(st.alloc, ep.slot, tokens)

    def _episode_admit(
        self, st: _PagedGenSession, ep: _EpisodeSlot, toks: np.ndarray, fresh: bool
    ) -> None:
        """Admission, host bookkeeping only (the serving chunk does the
        forwards).  fresh=True maps a slot for a whole conversation: the
        LONGEST published page-aligned prefix of it is mapped
        copy-on-write and only the tail is teacher-forced.  fresh=False
        appends an observation onto the slot's live pages from position
        cache_len on, overwriting any tail KV a stop rewind left."""
        alloc = st.alloc
        s = ep.slot
        ps = alloc.page_size
        g = ep.gconfig
        # Pages past the transcript for the chunk's decode steps and the
        # K draft positions a speculating row writes past its last token.
        slack = st.chunk_t + g.spec_decode_k
        st.ep_seq += 1
        ep.seq = st.ep_seq
        if fresh:
            plen = len(toks)
            start = 0
            if self.kv_share_prefix and plen > ps:
                # Longest first: the first hit is the best.  The tail keeps
                # >= 1 token, so the re-forward gives this conversation's
                # own next-token logits.
                for k in range((plen - 1) // ps, 0, -1):
                    shared = alloc.prefix_lookup(b"ep:" + toks[: k * ps].tobytes())
                    if shared is None:
                        continue
                    need = alloc.pages_for(plen + slack) - len(shared)
                    if need > len(alloc.free):
                        alloc.prefix_evict(need)
                    if need > len(alloc.free):
                        break  # too tight to grow past the shared pages
                    alloc.share(s, shared)
                    start = k * ps
                    break
            if start > 0:
                self.episode_prefix_hits += 1
            else:
                self.episode_prefix_misses += 1
            self._reserve_or_evict_parked(st, ep, plen + slack)
            st.active[s] = ep.ep_id
            st.cache_len[s] = start
            st.shared_from[s] = start
            st.slot_prompt[s] = toks
            rem = plen - start
        else:
            # Teacher-force everything past the KV cursor.  With K > 0 the
            # cursor parked ONE short of the transcript (its last token
            # was a pending spec token with no KV yet, see
            # _finish_episode_turn): it goes with the observation.
            st.slot_prompt[s] = np.concatenate([st.slot_prompt[s], toks])
            start = int(st.cache_len[s])
            toks = st.slot_prompt[s][start:]
            rem = len(toks)
        st.toks_acc[s] = []
        st.logps_acc[s] = []
        st.gen_count[s] = 0
        st.done_host[s] = False
        st.prompt_buf[s, :] = self.pad_token_id
        st.prompt_buf[s, :rem] = toks[len(toks) - rem :]
        st.prefill_rem[s] = rem
        st.prompt_off[s] = 0
        st.last_emit[s] = 0
        ep.last_admit_tokens = rem
        ep.turn_start_len = start + rem
        # The turn's budget, clamped so the transcript never outgrows the
        # episode's token budget (the page reservation and the admission
        # width rely on that bound).
        left = ep.token_budget - ep.turn_start_len if ep.token_budget else g.max_new_tokens
        ep.turn_max_new = max(0, min(g.max_new_tokens, left))
        ep.budget_limited = ep.turn_max_new < g.max_new_tokens

    def _episode_chunk_fn(self, st: _PagedGenSession, g: GenerationHyperparameters):
        """The session's serving chunk for `g`, built once per signature
        (the JAX engine's compile cache) with its lane budget."""
        W, pbw = st.prefill_chunk, st.prompt_buf.shape[1]
        sig = (st.n_slots, st.n_pages, st.max_pages, st.chunk_t, W, pbw,
               g.spec_decode_k, g.spec_ngram, g.min_new_tokens, g.greedy, g.top_p,
               g.top_k, g.temperature, self.serving_admit_lanes)
        if sig not in st.chunk_fns:
            fn = self._get_serving_chunk_fn(
                st.n_slots, st.n_pages, st.max_pages, st.chunk_t, W, pbw, g
            )
            st.chunk_fns[sig] = (fn, self.serving_lane_budget)
        fn, self.serving_lane_budget = st.chunk_fns[sig]
        return fn

    def _run_episode_turn(
        self, st: _PagedGenSession, ep: _EpisodeSlot
    ) -> Optional[Dict[str, Any]]:
        """Run serving chunks until THIS episode's turn ends (a stop
        sequence, EOS, the turn's length or the episode's budget).  Other
        episodes' slots ride along as done rows: zero lanes.  Checks the
        interrupt at every chunk boundary: a weight push parks the turn
        in place (returns None) and episode_resume() replays the last
        chunk tail on the same pages before going on."""
        g = ep.gconfig
        s = ep.slot
        alloc = st.alloc
        chunk_t, W = st.chunk_t, st.prefill_chunk
        chunk_fn = self._episode_chunk_fn(st, g)
        max_new = ep.turn_max_new
        K = g.spec_decode_k
        Wmax = max(W, K + 1)
        to_dev = self._to_dev
        reason = None
        while reason is None:
            if self._interrupt_evt.is_set():
                ep.parked_mid_turn = True
                tracer.counter("episode_interrupt", slot=s, cache_len=int(st.cache_len[s]))
                return None
            rem = int(st.prefill_rem[s])
            left = max(0, max_new - int(st.gen_count[s]))
            target = int(st.cache_len[s]) + max(
                1, min(chunk_t * Wmax, rem + chunk_t * (K + 1), rem + left + K)
            )
            self._reserve_or_evict_parked(st, ep, target)
            self._privatize_write_windows(st)
            self._accum_pool_stats(
                "paged", int(st.cache_len.sum()), alloc.allocated_pages() * alloc.page_size
            )
            prev_gen = st.gen_count.copy()
            with tracer.span("episode_chunk", cat="compute", t=chunk_t, w=W):
                (
                    out_toks, out_logps, new_cache_len, new_gen_count, new_done,
                    new_rem, new_off, lane_acc,
                ) = chunk_fn(
                    self.params, st.pool, st.logits_buf,
                    to_dev(alloc.table), to_dev(st.prompt_buf.astype(np.int64)),
                    to_dev(st.prompt_off.astype(np.int64)),
                    to_dev(st.prefill_rem.astype(np.int64)),
                    to_dev(st.cache_len.astype(np.int64)),
                    to_dev(st.gen_count.astype(np.int64)),
                    to_dev(st.done_host), st.tokens_buf, st.pending_tok, st.generator,
                )
                # The chunk's one host sync, at its boundary.
                out_toks = out_toks.cpu().numpy()
                out_logps = out_logps.cpu().numpy()
                lane_acc = lane_acc.cpu().numpy()
                st.done_host = new_done.cpu().numpy()
                st.cache_len = new_cache_len.cpu().numpy().astype(np.int32)
                st.gen_count = new_gen_count.cpu().numpy().astype(np.int32)
                st.prefill_rem = new_rem.cpu().numpy().astype(np.int32)
                st.prompt_off = new_off.cpu().numpy().astype(np.int32)
            st.last_emit = st.gen_count - prev_gen
            self.steps_total += chunk_t
            self.lanes_dispatched += chunk_t * self.serving_lane_budget
            self.lanes_live += int(lane_acc[0])
            self.lanes_slack += int(lane_acc[1])
            self.dead_live_lanes += int(lane_acc[2])
            # Drain THIS slot only (parked rows emit nothing).
            row = out_toks[s]
            term = np.flatnonzero(row < 0)
            limit = int(term[0]) if term.size else row.shape[0]
            limit = min(limit, max(0, max_new - len(st.toks_acc[s])))
            eos_at = np.flatnonzero(row[:limit] == self.eos_token_id)
            if eos_at.size:
                limit = int(eos_at[0]) + 1
            prev_len = len(st.toks_acc[s])
            st.toks_acc[s].extend(row[:limit].tolist())
            st.logps_acc[s].extend(out_logps[s, :limit].tolist())
            cut = _find_stop_end(st.toks_acc[s], prev_len, g.stop) if g.stop else None
            if cut is not None:
                del st.toks_acc[s][cut:]
                del st.logps_acc[s][cut:]
                reason = "stop"
            elif st.toks_acc[s] and st.toks_acc[s][-1] == self.eos_token_id:
                reason = "eos"
            elif int(st.prefill_rem[s]) == 0 and len(st.toks_acc[s]) >= max_new:
                reason = "budget" if ep.budget_limited else "length"
        return self._finish_episode_turn(st, ep, reason)

    def _finish_episode_turn(
        self, st: _PagedGenSession, ep: _EpisodeSlot, reason: str
    ) -> Dict[str, Any]:
        s = ep.slot
        kept = len(st.toks_acc[s])
        # Rewind: tokens sampled past the kept boundary (after a stop
        # sequence, or over the turn's budget) left KV the transcript no
        # longer covers.  Pulling cache_len back is host bookkeeping:
        # attention never reads past a row's cursor, and the next
        # admission teacher-forces over those positions in place.  With
        # spec decoding the last kept token may still be PENDING (no KV
        # yet): park one short, and the next admission forwards it.
        if ep.gconfig.spec_decode_k > 0:
            st.cache_len[s] = ep.turn_start_len + max(0, kept - 1)
        else:
            st.cache_len[s] = ep.turn_start_len + kept
        st.done_host[s] = True
        st.prefill_rem[s] = 0
        turn_toks = [int(t) for t in st.toks_acc[s]]
        turn_lps = [float(x) for x in st.logps_acc[s]]
        if turn_toks:
            st.slot_prompt[s] = np.concatenate(
                [st.slot_prompt[s], np.asarray(turn_toks, np.int32)]
            )
        st.toks_acc[s] = []
        st.logps_acc[s] = []
        ep.turns += 1
        self._episode_publish_prefix(st, s)
        self._set_live_slots(len(st.episodes))
        return {
            "episode_id": ep.ep_id,
            "turn_index": ep.turns - 1,
            "tokens": turn_toks,
            "logprobs": turn_lps,
            "stop_reason": reason,
            "transcript_len": int(ep.turn_start_len + kept),
            "prefill_tokens": int(ep.last_admit_tokens),
            "shared_prefix_tokens": int(st.shared_from[s]),
            "slot": s,
        }

    def _episode_publish_prefix(self, st: _PagedGenSession, s: int) -> None:
        """Publish the slot's page-aligned transcript prefix, so a later
        conversation that shares it (another episode with the same system
        prompt, or this transcript re-admitted after SlotGone) maps the
        pages instead of prefilling them.  Keys are the prefix's int32
        token bytes, page-aligned, so an admission probes longest first."""
        if not self.kv_share_prefix:
            return
        alloc = st.alloc
        sp = int(st.cache_len[s]) // alloc.page_size
        if sp <= 0:
            return
        alloc.prefix_insert(
            b"ep:" + st.slot_prompt[s][: sp * alloc.page_size].tobytes(),
            alloc.table[s, :sp],
        )

    # -- the dense inflight window --

    def _generate_inflight(self, reqs, gconfig, seed, results) -> None:
        """A fixed slot pool: finished rows retire and pending requests
        join between decode chunks.  The mode follows the JAX engine:
        the serving plane (paged, prefill_chunk_tokens > 0), the
        two-program paged path (prefill_chunk_tokens = 0), or the dense
        window (kv_paged=False), plain or speculative."""
        if self.kv_paged:
            if self.prefill_chunk_tokens > 0:
                return self._generate_inflight_serving(reqs, gconfig, seed, results)
            if gconfig.spec_decode_k > 0:
                raise ValueError(
                    "spec_decode_k > 0 over the paged pool requires the "
                    "serving plane (prefill_chunk_tokens > 0)"
                )
            return self._generate_inflight_plain_paged(reqs, gconfig, seed, results)
        if gconfig.spec_decode_k > 0:
            return self._generate_inflight_spec(reqs, gconfig, seed, results)
        return self._generate_inflight_plain(reqs, gconfig, seed, results)

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _chunk_fn(self, sig, build):
        """The decode-chunk function of signature `sig`, built (and
        counted in decode_compiles) once per generate call."""
        fn = self._chunk_fns.get(sig)
        if fn is None:
            fn = self._chunk_fns[sig] = build()
            self.decode_compiles += 1
            self._m_decode_compiles.inc()
        return fn

    def _kv_dtype(self):
        """Every inflight mode's KV cache dtype (the static path keeps the
        compute dtype, as in the JAX package)."""
        return "int8" if self.kv_cache_dtype == "int8" else self.compute_dtype

    def _generate_inflight_plain(self, reqs, gconfig, seed, results) -> None:
        n_slots = min(self.max_decode_batch, len(reqs))
        max_prompt = max(len(t) for (_, _, t) in reqs)
        chunk_t = min(32, gconfig.max_new_tokens)
        # The window starts at the smallest bucket covering the prompts and
        # grows through buckets as rows lengthen: every decode step reads
        # the whole window, so depth it does not need yet is wasted.
        cur_w = bucket_len(max_prompt + chunk_t)
        dev = self.device
        cache = tfm.init_kv_cache(
            self.cfg, n_slots, cur_w, dtype=self._kv_dtype(), device=dev
        )
        logits_buf = torch.zeros((n_slots, self.cfg.vocab_size), dtype=torch.float32, device=dev)
        generator = torch.Generator(device=dev).manual_seed(int(seed))
        cache_len = np.zeros((n_slots,), np.int32)
        gen_count = np.zeros((n_slots,), np.int32)
        done_host = np.ones((n_slots,), bool)  # empty slots count as done
        active: List[Optional[Tuple[int, int]]] = [None] * n_slots
        toks_acc: Dict[int, List[int]] = {}
        logps_acc: Dict[int, List[float]] = {}
        pending = list(reversed(reqs))  # pop() takes the longest first
        while pending or any(a is not None for a in active):
            # Refill every free slot with ONE batched prefill.
            admits = self._take_admits(active, pending, n_slots)
            if admits:
                rows, plens, slots = self._pack_admits(admits, n_slots)
                with tracer.span("prefill", cat="compute", n=len(admits)):
                    logits, _ = tfm.prefill_into_slots(
                        self.params, self.cfg, self._to_dev(rows), self._to_dev(plens),
                        cache, torch.from_numpy(slots),
                    )
                    keep = slots < n_slots
                    logits_buf[self._to_dev(slots[keep])] = logits[
                        self._to_dev(np.flatnonzero(keep))]
                self.prefill_dispatches += 1
                for s, i, rep, toks in admits:
                    cache_len[s] = len(toks)
                    gen_count[s] = 0
                    done_host[s] = False
                    active[s] = (i, rep)
                    toks_acc[s] = []
                    logps_acc[s] = []
            # Grow the window when the next chunk could overflow it: by
            # doubling, so copies stay O(log length).  Retired slots have
            # cache_len 0 and drive no growth.
            old_bytes = cache.nbytes()
            cache, new_w = self._grow_kv_cache(cache, cur_w, int(cache_len.max()) + chunk_t)
            if new_w != cur_w:
                self.cache_copy_bytes += old_bytes
                cur_w = new_w
            self._accum_pool_stats("dense", int(cache_len.sum()), n_slots * cur_w)
            decode_fn = self._get_inflight_decode_fn(n_slots, cur_w, chunk_t, gconfig)
            with tracer.span("decode_chunk", cat="compute", t=chunk_t):
                out_toks, out_logps, new_cache_len, new_gen_count, new_done = decode_fn(
                    self.params, cache, logits_buf, self._to_dev(cache_len.astype(np.int64)),
                    self._to_dev(gen_count.astype(np.int64)), self._to_dev(done_host),
                    generator,
                )
                # The chunk's one host sync.
                out_toks, out_logps = out_toks.cpu().numpy(), out_logps.cpu().numpy()
                cache_len = new_cache_len.cpu().numpy().astype(np.int32)
                gen_count = new_gen_count.cpu().numpy().astype(np.int32)
                new_done = new_done.cpu().numpy()
            self.steps_total += chunk_t
            self._drain_chunk_outputs(
                out_toks, out_logps, new_done, active, toks_acc,
                logps_acc, results, done_host, cache_len, gconfig.max_new_tokens,
                stop_seqs=gconfig.stop,
            )
        self._set_live_slots(0)

    def _take_admits(self, active, pending, n_slots):
        """Assign pending requests to free slots, longest prompt first
        (`pending` is sorted ascending, so pop() takes the longest)."""
        admits = []
        for s in range(n_slots):
            if active[s] is None and pending:
                i, rep, toks = pending.pop()
                admits.append((s, i, rep, toks))
        self._set_live_slots(sum(a is not None for a in active) + len(admits))
        tracer.counter("gen_slots", live=self.live_slots, pending=len(pending))
        return admits

    def _pack_admits(self, admits, n_slots):
        """One refill's admissions as arrays, in the JAX engine's layout:
        SP buckets to the longest admitted prompt and M to the next power
        of two, padding rows carrying one pad token and the out-of-range
        slot id n_slots.  `prefill_into_slots` selects the padding rows
        out before its forward, so they cost nothing here (a topk MoE
        runs them, as the JAX package does)."""
        sp = bucket_len(max(len(t) for (_, _, _, t) in admits))
        m = 1
        while m < len(admits):
            m *= 2
        rows = np.full((m, sp), self.pad_token_id, np.int64)
        plens = np.ones((m,), np.int64)
        slots = np.full((m,), n_slots, np.int64)
        for j, (s, _, _, toks) in enumerate(admits):
            rows[j, : len(toks)] = toks
            plens[j] = len(toks)
            slots[j] = s
        return rows, plens, slots

    def _plain_decode_chunk(self, sig, n_slots: int, chunk_t: int,
                            g: GenerationHyperparameters, forward):
        """A plain (one token a row) decode chunk: chunk_t steps of sample
        -> `forward(params, tokens, cache_len, kv, *aux, layers=)` on the device,
        done rows masked (they re-write their current position with EOS,
        past their window), the logits buffer carried in place.  The
        dense window and the two-program paged path differ only in
        `forward`."""
        cfg, eos, dev = self.cfg, self.eos_token_id, self.device

        def build():
            def fn(params, kv, logits_buf, cache_len, gen_count, done, generator, *aux):
                out_toks = torch.full((n_slots, chunk_t), -1, dtype=torch.long, device=dev)
                out_logps = torch.zeros((n_slots, chunk_t), dtype=torch.float32, device=dev)
                logits = logits_buf
                eos_col = torch.arange(cfg.vocab_size, device=dev) == eos
                layers = tfm.layer_views(params)
                for t in range(chunk_t):
                    lg = logits
                    if g.min_new_tokens > 0:
                        lg = lg.masked_fill(
                            (gen_count < g.min_new_tokens)[:, None] & eos_col[None, :],
                            -1e10,
                        )
                    tok, logp = sample_token(
                        lg, generator, temperature=g.temperature, top_k=g.top_k,
                        top_p=g.top_p, greedy=g.greedy,
                    )
                    out_toks[:, t] = torch.where(done, -1, tok)
                    out_logps[:, t] = torch.where(done, 0.0, logp)
                    logits, _ = forward(
                        params, torch.where(done, eos, tok), cache_len, kv, *aux, layers=layers
                    )
                    live = (~done).long()
                    done = done | (tok == eos)
                    cache_len = cache_len + live
                    gen_count = gen_count + live
                logits_buf.copy_(logits)
                return out_toks, out_logps, cache_len, gen_count, done

            return fn

        return self._chunk_fn(
            sig + (n_slots, chunk_t, g.min_new_tokens, g.greedy, g.top_p, g.top_k,
                   g.temperature),
            build,
        )

    def _get_inflight_decode_fn(
        self, n_slots: int, s_max: int, chunk_t: int, g: GenerationHyperparameters
    ):
        """The dense window's decode chunk over `decode_step_inflight`:
        each row writes at its cache_len, clamped into the window.  One
        build per window width."""
        cfg = self.cfg

        def forward(params, tok, cache_len, cache, layers=None):
            return tfm.decode_step_inflight(
                params, cfg, tok, cache_len, cache,
                slots=torch.clamp(cache_len, max=s_max - 1),
                valid_to=torch.clamp(cache_len + 1, max=s_max), layers=layers,
            )

        return self._plain_decode_chunk(("inflight", s_max), n_slots, chunk_t, g, forward)

    @staticmethod
    def _grow_kv_cache(cache, cur_w: int, need: int):
        """Doubling window growth (a copy into a zeroed wider cache);
        no-op when `need` fits."""
        if need <= cur_w:
            return cache, cur_w
        new_w = bucket_len(max(need, 2 * cur_w))

        def grow(a):
            if a is None:
                return None
            out = torch.zeros(
                (*a.shape[:2], new_w, *a.shape[3:]), dtype=a.dtype, device=a.device
            )
            out[:, :, :cur_w] = a
            return out

        return (
            tfm.KVCache(
                k=grow(cache.k), v=grow(cache.v),
                k_scale=grow(cache.k_scale), v_scale=grow(cache.v_scale),
            ),
            new_w,
        )

    # -- speculative decoding on the dense window --

    def _generate_inflight_spec(self, reqs, g, seed, results) -> None:
        """The dense window with speculative decoding: each step forwards
        [pending, K drafts] in ONE `decode_step_spec` (the weights read
        once for up to K+1 tokens); drafts come from n-gram lookup in the
        row's own history and are verified exactly (`spec_accept`), so
        the emitted distribution is plain sampling's.  Admission samples
        each row's first (pending) token right after its prefill."""
        K = g.spec_decode_k
        n_slots = min(self.max_decode_batch, len(reqs))
        max_prompt = max(len(t) for (_, _, t) in reqs)
        n_steps = max(1, min(32, g.max_new_tokens) // (K + 1))
        step_cap = n_steps * (K + 1)
        cur_w = bucket_len(max_prompt + step_cap + K + 1)
        dev = self.device
        cache = tfm.init_kv_cache(
            self.cfg, n_slots, cur_w, dtype=self._kv_dtype(), device=dev
        )
        # History buffer (prompt + emitted tokens) of width cur_w + K + 2,
        # plus K + 1 scratch columns (see _spec_emit).
        tokens_buf = torch.zeros((n_slots, cur_w + 2 * K + 3), dtype=torch.long, device=dev)
        pending = torch.zeros((n_slots,), dtype=torch.long, device=dev)
        generator = torch.Generator(device=dev).manual_seed(int(seed))
        cache_len = np.zeros((n_slots,), np.int32)
        gen_count = np.zeros((n_slots,), np.int32)
        done_host = np.ones((n_slots,), bool)
        active: List[Optional[Tuple[int, int]]] = [None] * n_slots
        toks_acc: Dict[int, List[int]] = {}
        logps_acc: Dict[int, List[float]] = {}
        pending_list = list(reversed(reqs))
        while pending_list or any(a is not None for a in active):
            admits = self._take_admits(active, pending_list, n_slots)
            if admits:
                rows, plens, slots = self._pack_admits(admits, n_slots)
                with tracer.span("prefill", cat="compute", n=len(admits)):
                    toks0, logps0 = self._spec_admit(
                        g, rows, plens, cache, tokens_buf, pending, slots, generator
                    )
                    # One host sync per refill: the done flag must be
                    # exact before the next chunk.
                    toks0, logps0 = toks0.cpu().numpy(), logps0.cpu().numpy()
                self.prefill_dispatches += 1
                for j, (s, i, rep, toks) in enumerate(admits):
                    t0 = int(toks0[j])
                    cache_len[s] = len(toks)
                    gen_count[s] = 1  # the sampled pending token
                    done_host[s] = t0 == self.eos_token_id
                    active[s] = (i, rep)
                    toks_acc[s] = [t0]
                    logps_acc[s] = [float(logps0[j])]
            # A chunk adds up to step_cap entries (+K scratch).
            old_bytes = cache.nbytes()
            cache, new_w = self._grow_kv_cache(
                cache, cur_w, int(cache_len.max()) + step_cap + K + 1
            )
            if new_w != cur_w:
                self.cache_copy_bytes += old_bytes
                grown = torch.zeros(
                    (n_slots, new_w + 2 * K + 3), dtype=torch.long, device=dev
                )
                grown[:, : cur_w + K + 2] = tokens_buf[:, : cur_w + K + 2]
                tokens_buf, cur_w = grown, new_w
            self._accum_pool_stats("dense", int(cache_len.sum()), n_slots * cur_w)
            fn = self._get_spec_decode_fn(n_slots, cur_w, n_steps, g)
            with tracer.span("decode_chunk", cat="compute", t=step_cap):
                out_toks, out_logps, new_cache_len, new_gen_count, new_done = fn(
                    self.params, cache, tokens_buf, pending,
                    self._to_dev(cache_len.astype(np.int64)),
                    self._to_dev(gen_count.astype(np.int64)), self._to_dev(done_host),
                    generator,
                )
                out_toks, out_logps = out_toks.cpu().numpy(), out_logps.cpu().numpy()
                cache_len = new_cache_len.cpu().numpy().astype(np.int32)
                gen_count = new_gen_count.cpu().numpy().astype(np.int32)
                new_done = new_done.cpu().numpy()
            self.steps_total += n_steps
            self._drain_chunk_outputs(
                out_toks, out_logps, new_done, active, toks_acc,
                logps_acc, results, done_host, cache_len, g.max_new_tokens,
                stop_seqs=g.stop,
            )
        self._set_live_slots(0)

    def _spec_admit(self, g, rows, plens, cache, tokens_buf, pending, slots, generator):
        """The dense spec path's batched admission: prefill every admitted
        prompt into its row (`prefill_into_slots`), sample its first
        pending token (EOS masked under min_new_tokens), and record prompt
        and token in the history buffer and `pending` (in place).
        Returns the device tokens and logprobs [M]; padding rows' are
        garbage."""
        cfg, dev = self.cfg, self.device
        rows_d = self._to_dev(rows)
        logits, _ = tfm.prefill_into_slots(
            self.params, cfg, rows_d, self._to_dev(plens), cache, torch.from_numpy(slots)
        )
        if g.min_new_tokens > 0:
            eos_col = torch.arange(cfg.vocab_size, device=dev) == self.eos_token_id
            logits = logits.masked_fill(eos_col[None, :], -1e10)
        tok, logp = sample_token(
            logits, generator, temperature=g.temperature, top_k=g.top_k,
            top_p=g.top_p, greedy=g.greedy,
        )
        keep = np.flatnonzero(slots < pending.shape[0])
        keep_d, dst = self._to_dev(keep), self._to_dev(slots[keep])
        tokens_buf[dst, : rows.shape[1]] = rows_d[keep_d]
        tokens_buf[dst, self._to_dev(plens[keep])] = tok[keep_d]
        pending[dst] = tok[keep_d]
        return tok, logp

    def _get_spec_decode_fn(
        self, n_slots: int, s_max: int, n_steps: int, g: GenerationHyperparameters
    ):
        """The dense spec chunk: n_steps steps of propose -> one
        `decode_step_spec` over [pending, drafts] at slots0 = cache_len
        (clamped to s_max - 1 - K; done rows forward EOS) -> `_spec_emit`,
        all on the device.  The history buffer and `pending` are updated
        in place."""
        K = g.spec_decode_k
        cfg, eos, dev = self.cfg, self.eos_token_id, self.device
        out_w = n_steps * (K + 1)
        buf_w = s_max + K + 2

        def build():
            def fn(params, cache, tokens_buf, pending_buf, cache_len, gen_count, done,
                   generator):
                out_toks = torch.full((n_slots, out_w + K + 1), -1, dtype=torch.long,
                                      device=dev)
                out_logps = torch.zeros((n_slots, out_w + K + 1), dtype=torch.float32,
                                        device=dev)
                out_fill = torch.zeros((n_slots,), dtype=torch.long, device=dev)
                rows = torch.arange(n_slots, device=dev)
                qi = torch.arange(K + 1, device=dev)
                pending = pending_buf
                layers = tfm.layer_views(params)
                for _ in range(n_steps):
                    drafts = propose_ngram(
                        tokens_buf[:, :buf_w], cache_len + 1, K, g.spec_ngram
                    )  # [B, K]
                    inputs = torch.cat([pending[:, None], drafts], dim=1)
                    slots0 = torch.clamp(cache_len, max=s_max - 1 - K)
                    logits, _ = tfm.decode_step_spec(
                        params, cfg, torch.where(done[:, None], eos, inputs),
                        slots0[:, None] + qi[None, :], cache, slots0, layers=layers,
                    )  # [B, K+1, V]
                    pending, cache_len, gen_count, done, out_fill = _spec_emit(
                        cfg, g, eos, rows, logits, drafts, generator, pending,
                        cache_len, gen_count, done, out_toks, out_logps, out_fill,
                        out_w, tokens_buf, buf_w,
                    )
                pending_buf.copy_(pending)
                return out_toks[:, :out_w], out_logps[:, :out_w], cache_len, gen_count, done

            return fn

        sig = ("spec_decode", n_slots, s_max, n_steps, K, g.spec_ngram,
               g.min_new_tokens, g.greedy, g.top_p, g.top_k, g.temperature)
        return self._chunk_fn(sig, build)

    # -- the two-program paged path --

    def _generate_inflight_plain_paged(self, reqs, gconfig, seed, results) -> None:
        """The plain inflight loop over a paged pool, admissions as their
        own program: the pool and the decode chunk keep one shape for the
        whole call, window growth is a host-side page append, and retired
        slots' pages are recycled into new admits."""
        n_slots = min(self.max_decode_batch, len(reqs))
        ps = self.kv_page_size
        chunk_t = min(32, gconfig.max_new_tokens)
        max_prompt = max(len(t) for (_, _, t) in reqs)
        # Page-table width: the worst-case footprint of a slot (prompt +
        # the whole budget + a chunk of slack past the live length).
        max_pages = -(-(max_prompt + gconfig.max_new_tokens + chunk_t) // ps)
        n_pages = self.kv_pool_pages or n_slots * max_pages
        dev = self.device
        st = _PagedGenSession(
            gconfig=gconfig,
            generator=torch.Generator(device=dev).manual_seed(int(seed)),
            results=results,
            n_slots=n_slots,
            n_pages=n_pages,
            max_pages=max_pages,
            chunk_t=chunk_t,
            alloc=PageAllocator(n_pages, ps, n_slots, max_pages),
            pool=tfm.init_paged_kv_cache(
                self.cfg, n_pages, ps, dtype=self._kv_dtype(), device=dev
            ),
            logits_buf=torch.zeros(
                (n_slots, self.cfg.vocab_size), dtype=torch.float32, device=dev
            ),
            cache_len=np.zeros((n_slots,), np.int32),
            gen_count=np.zeros((n_slots,), np.int32),
            done_host=np.ones((n_slots,), bool),
            active=[None] * n_slots,
            toks_acc={},
            logps_acc={},
            pending=list(reversed(reqs)),
            slot_prompt={},
            last_emit=np.zeros((n_slots,), np.int32),
            prefill_chunk=0,  # no prompt slices in the chunk: resume() reads it
            prompt_buf=np.zeros((n_slots, 1), np.int32),
            prefill_rem=np.zeros((n_slots,), np.int32),
            prompt_off=np.zeros((n_slots,), np.int32),
            shared_from=np.zeros((n_slots,), np.int32),
            slot_hash={},
            inflight_prefix={},
        )
        st.alloc.page_bytes = st.pool.nbytes() // (n_pages + 1)
        self._run_paged_loop(st)

    def _run_paged_loop(self, st: _PagedGenSession) -> bool:
        """The two-program chunk loop, interruptible at the top of every
        iteration like the serving loop: returns False parked (the session
        waits in `_session`), True finished."""
        gconfig = st.gconfig
        alloc = st.alloc
        n_slots, ps, chunk_t = st.n_slots, alloc.page_size, st.chunk_t
        decode_fn = self._get_paged_decode_fn(
            n_slots, st.n_pages, st.max_pages, chunk_t, gconfig
        )
        while st.pending or any(a is not None for a in st.active):
            if self._interrupt_evt.is_set():
                self._session = st
                self._count_interrupt(st)
                return False
            admits = self._take_admits_paged(st.active, st.pending, n_slots, alloc, chunk_t)
            if admits:
                rows, plens, slots, page_rows = self._pack_admits_paged(
                    admits, n_slots, alloc
                )
                # Padding rows (slot n_slots, sentinel pages) never run.
                keep = np.flatnonzero(slots < n_slots)
                with tracer.span("prefill", cat="compute", n=len(admits)):
                    logits, _ = tfm.prefill_into_pages(
                        self.params, self.cfg, self._to_dev(rows[keep]),
                        self._to_dev(plens[keep]), st.pool, self._to_dev(page_rows[keep]),
                    )
                    st.logits_buf[self._to_dev(slots[keep])] = logits
                self.prefill_dispatches += 1
                for s, i, rep, toks in admits:
                    st.cache_len[s] = len(toks)
                    st.gen_count[s] = 0
                    st.done_host[s] = False
                    st.active[s] = (i, rep)
                    st.toks_acc[s] = []
                    st.logps_acc[s] = []
                    st.slot_prompt[s] = np.asarray(toks, np.int32)
            # Map pages covering the next chunk of every live slot: a host
            # int append, no device copy.
            for s in range(n_slots):
                if st.active[s] is not None:
                    alloc.reserve(s, int(st.cache_len[s]) + chunk_t)
            self._accum_pool_stats(
                "paged", int(st.cache_len.sum()), alloc.allocated_pages() * ps
            )
            prev_gen = st.gen_count.copy()
            with tracer.span("decode_chunk", cat="compute", t=chunk_t):
                out_toks, out_logps, new_cache_len, new_gen_count, new_done = decode_fn(
                    self.params, st.pool, st.logits_buf,
                    self._to_dev(st.cache_len.astype(np.int64)),
                    self._to_dev(st.gen_count.astype(np.int64)), self._to_dev(st.done_host),
                    st.generator, self._to_dev(alloc.table),
                )
                out_toks, out_logps = out_toks.cpu().numpy(), out_logps.cpu().numpy()
                st.cache_len = new_cache_len.cpu().numpy().astype(np.int32)
                st.gen_count = new_gen_count.cpu().numpy().astype(np.int32)
                new_done = new_done.cpu().numpy()
            # Tokens each slot emitted this chunk: the tail a resume replays.
            st.last_emit = st.gen_count - prev_gen
            self.steps_total += chunk_t

            def _retire(s):
                alloc.release(s)
                st.slot_prompt.pop(s, None)

            self._drain_chunk_outputs(
                out_toks, out_logps, new_done, st.active,
                st.toks_acc, st.logps_acc, st.results, st.done_host,
                st.cache_len, gconfig.max_new_tokens, on_retire=_retire,
                stop_seqs=gconfig.stop,
            )
        self.last_pool_stats.update(
            pool_pages=st.n_pages, page_size=ps,
            pages_recycled=alloc.pages_recycled,
            peak_pages_used=alloc.peak_pages_used,
            pool_bytes=alloc.pool_bytes(),
            peak_allocated_bytes=alloc.peak_pages_used * alloc.page_bytes,
        )
        self._set_live_slots(0)
        return True

    def _take_admits_paged(self, active, pending, n_slots, alloc, slack):
        """`_take_admits` against the page budget: a request is admitted
        only when the allocator can map its prompt plus `slack` decode
        tokens; otherwise it waits for retirements.  Raises
        PagePoolExhausted when nothing is live and the head request still
        cannot fit."""
        admits = []
        for s in range(n_slots):
            if active[s] is None and pending:
                plen = len(pending[-1][2])
                if not alloc.can_reserve(s, plen + slack):
                    break
                i, rep, toks = pending.pop()
                alloc.reserve(s, plen + slack)
                admits.append((s, i, rep, toks))
        if not admits and pending and not any(a is not None for a in active):
            free_slot = next(s for s in range(n_slots) if active[s] is None)
            alloc.reserve(free_slot, len(pending[-1][2]) + slack)  # raises
        self._set_live_slots(sum(a is not None for a in active) + len(admits))
        tracer.counter("gen_slots", live=self.live_slots, pending=len(pending))
        return admits

    def _pack_admits_paged(self, admits, n_slots, alloc):
        """`_pack_admits` with SP a whole number of pages, and each row's
        pool pages (sentinel past its prompt, and on padding rows)."""
        rows, plens, slots = self._pack_admits(admits, n_slots)
        ps = alloc.page_size
        sp = rows.shape[1]
        if sp % ps:
            rows = np.pad(rows, [(0, 0), (0, ps - sp % ps)],
                          constant_values=self.pad_token_id)
            sp = rows.shape[1]
        page_rows = np.full((rows.shape[0], sp // ps), alloc.sentinel, np.int64)
        for j, (s, _, _, toks) in enumerate(admits):
            n = alloc.pages_for(len(toks))
            page_rows[j, :n] = alloc.table[s, :n]
        return rows, plens, slots, page_rows

    def _get_paged_decode_fn(
        self, n_slots: int, n_pages: int, max_pages: int, chunk_t: int,
        g: GenerationHyperparameters,
    ):
        """The two-program path's decode chunk over `decode_step_paged`
        (its page table the chunk's extra argument).  Done rows keep
        re-writing their current position, still mapped until the slot
        retires; the reserve() before each chunk maps every other write.
        Its shape depends only on the pool: one build per call."""
        cfg = self.cfg

        def forward(params, tok, cache_len, pool, page_table, layers=None):
            return tfm.decode_step_paged(
                params, cfg, tok, cache_len, pool, page_table, cache_len, cache_len + 1,
                layers=layers,
            )

        return self._plain_decode_chunk(
            ("paged_inflight", n_pages, max_pages), n_slots, chunk_t, g, forward
        )


    # -- the static path --

    def _generate_chunk(self, chunk, gconfig, generator, results) -> None:
        """One fixed-shape chunk of requests: right-aligned prompts, so
        every row's next token lands at the same cache slot (sp + step)."""
        b = len(chunk)
        sp = bucket_len(max(len(t) for (_, _, t) in chunk))
        s_total = bucket_len(sp + gconfig.max_new_tokens)
        prompt_tok = np.full((b, sp), self.pad_token_id, np.int64)
        prompt_len = np.zeros((b,), np.int64)
        for r, (_, _, toks) in enumerate(chunk):
            prompt_tok[r, sp - len(toks) :] = toks
            prompt_len[r] = len(toks)
        # Ends at the program's host read of its outputs.
        with tracer.span("gen_chunk", cat="compute", b=b, sp=sp):
            toks, logps, gen_len = self._static_program(
                prompt_tok, prompt_len, sp, s_total, gconfig, generator
            )
        for r, (i, rep, _) in enumerate(chunk):
            gl = int(gen_len[r])
            no_eos = gl == gconfig.max_new_tokens and (
                gl == 0 or toks[r, gl - 1] != self.eos_token_id
            )
            results[(i, rep)] = (toks[r, :gl], logps[r, :gl], no_eos)

    @torch.inference_mode()
    def _static_program(
        self, prompt_tok: np.ndarray, prompt_len: np.ndarray, sp: int,
        s_total: int, g: GenerationHyperparameters, generator: torch.Generator,
    ):
        """Prefill, then the decode loop over a dense [L, B, s_total]
        cache.  Step t samples every row's token from the carried logits
        (EOS masked with -1e10 while t < min_new_tokens); a done row
        emits EOS into the cache and 0 into the outputs, and its emission
        count stops; then one `decode_step` writes slot sp + t at RoPE
        position prompt_len + t and attends [sp - prompt_len, sp + t].

        The loop ends when every row is done or after max_new samples.
        The host reads the done flag once per step, of the step just
        sampled, while that step's forward is already queued: the card
        never waits for the host, and the last forward's logits, as in
        the JAX program, go unread.  After the last sample no forward is
        run.  Done rows change no output, so the results do not depend
        on when the flag is read.  The weights are bound once, at the
        burst's start, as the JAX program takes them: a `set_params` from
        another thread mid-burst (a weight sync under asynchronous RL)
        reaches the next burst, not this one's tail.  Returns host
        arrays (tokens [B, max_new], logprobs [B, max_new], emitted
        counts [B])."""
        cfg, dev, eos = self.cfg, self.device, self.eos_token_id
        params = self.params
        layers = tfm.layer_views(params)
        max_new = g.max_new_tokens
        b = prompt_tok.shape[0]
        tok_in = torch.from_numpy(prompt_tok).to(dev)
        plen = torch.from_numpy(prompt_len).to(dev)
        valid_from = sp - plen  # [B] first live cache slot
        seg = (torch.arange(sp, device=dev)[None, :] >= valid_from[:, None]).long()
        cache = tfm.init_kv_cache(cfg, b, s_total, dtype=self.compute_dtype, device=dev)
        logits, cache = tfm.prefill(params, cfg, tok_in, seg, cache)
        self.static_chunks += 1
        out_toks = torch.zeros((b, max_new), dtype=torch.long, device=dev)
        out_logps = torch.zeros((b, max_new), dtype=torch.float32, device=dev)
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        gen_len = torch.zeros((b,), dtype=torch.long, device=dev)
        eos_col = torch.arange(cfg.vocab_size, device=dev) == eos
        on_card = dev.type == "cuda"
        if on_card:
            all_done = torch.empty((), dtype=torch.bool, pin_memory=True)
            flag_ready = torch.cuda.Event()
        for step in range(max_new):
            lg = logits
            if step < g.min_new_tokens:
                lg = lg.masked_fill(eos_col[None, :], -1e10)
            tok, logp = sample_token(
                lg, generator, temperature=g.temperature, top_k=g.top_k,
                top_p=g.top_p, greedy=g.greedy,
            )
            tok = torch.where(done, eos, tok)
            out_toks[:, step] = torch.where(done, 0, tok)
            out_logps[:, step] = torch.where(done, 0.0, logp)
            gen_len += (~done).long()
            done = done | (tok == eos)
            if step + 1 == max_new:
                break
            if on_card:
                all_done.copy_(done.all(), non_blocking=True)
                flag_ready.record()
            logits, cache = tfm.decode_step(
                params, cfg, tok, plen + step, cache, sp + step, valid_from, layers=layers
            )
            self.static_decode_steps += 1
            if on_card:
                flag_ready.synchronize()
                finished = bool(all_done)
            else:
                finished = bool(done.all())
            if finished:
                break
        return (
            out_toks.cpu().numpy(), out_logps.cpu().numpy(),
            gen_len.cpu().numpy(),
        )

    # -- output assembly --

    def _assemble(self, sample, prompt_key, prompt_lens, results, n):
        toks = sum(len(t[0]) for t in results.values())
        self._m_tokens.inc(toks)
        dt = time.monotonic() - getattr(self, "_gen_t0", time.monotonic())
        if dt > 0:
            # Wall-clock goodput of the whole call, park time included:
            # the per-server throughput the fleet table reports.
            self._m_goodput.set(toks / dt)
        return assemble_rollout(
            sample, prompt_key, n,
            lambda i, r: results[(i, r)],
            prompt_lens=prompt_lens,
        )


def assemble_rollout(
    sample: SequenceSample,
    prompt_key: str,
    n: int,
    fetch,  # (prompt_idx, response_idx) -> (gen_tokens, gen_logprobs, no_eos)
    prompt_lens: Optional[List[int]] = None,
) -> SequenceSample:
    """The rollout packing layout: per response, full = prompt + generated
    tokens; prompt_mask covers the prompt; packed_logprobs has length
    len(full)-1 with the generated-token logprobs at
    [pl-1, pl-1+len(gen))."""
    bs = sample.bs
    prompts = np.asarray(sample.data[prompt_key])
    bounds = sample.cu_seqlens(prompt_key)
    if prompt_lens is None:
        prompt_lens = [int(bounds[i + 1] - bounds[i]) for i in range(bs)]
    seq_ids, seq_logps, seq_masks = [], [], []
    seqlens_full: List[List[int]] = []
    seqlens_lp: List[List[int]] = []
    no_eos: List[List[float]] = []
    for i in range(bs):
        lens_i, lens_lp_i, noeos_i = [], [], []
        ptoks = prompts[bounds[i] : bounds[i + 1]]
        pl = prompt_lens[i]
        for r in range(n):
            gtoks, glogps, ne = fetch(i, r)
            gtoks = np.asarray(gtoks, np.int32)
            glogps = np.asarray(glogps, np.float32)
            full = np.concatenate([ptoks, gtoks]).astype(np.int32)
            seq_ids.append(full)
            mask = np.zeros(len(full), bool)
            mask[:pl] = True
            seq_masks.append(mask)
            lp = np.zeros(max(len(full) - 1, 0), np.float32)
            lp[pl - 1 : pl - 1 + len(gtoks)] = glogps
            seq_logps.append(lp)
            lens_i.append(len(full))
            lens_lp_i.append(max(len(full) - 1, 0))
            noeos_i.append(1.0 if ne else 0.0)
        seqlens_full.append(lens_i)
        seqlens_lp.append(lens_lp_i)
        no_eos.append(noeos_i)
    return SequenceSample(
        keys={
            "packed_input_ids", "packed_logprobs", "prompt_mask",
            "seq_no_eos_mask",
        },
        ids=list(sample.ids),
        seqlens={
            "packed_input_ids": seqlens_full,
            "prompt_mask": [list(x) for x in seqlens_full],
            "packed_logprobs": seqlens_lp,
            "seq_no_eos_mask": [[1] * n for _ in range(bs)],
        },
        data={
            "packed_input_ids": np.concatenate(seq_ids),
            "prompt_mask": np.concatenate(seq_masks),
            "packed_logprobs": np.concatenate(seq_logps)
            if seq_logps
            else np.zeros(0, np.float32),
            "seq_no_eos_mask": np.asarray(
                [x for row in no_eos for x in row], np.float32
            ),
        },
    )
