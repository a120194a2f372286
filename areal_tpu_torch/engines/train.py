"""Training engine (port of areal_tpu/engines/train.py, one device).

- Master parameters and AdamW's `mu`/`nu` in `master_dtype` (fp32 by
  default, or bf16: 6 bytes a parameter instead of 12, and no compute
  copy) on the engine's device; each micro-batch casts the masters to
  the compute dtype (bf16 on the card, fp32 on the CPU, as the JAX
  package's CPU backend) INSIDE autograd, so gradients land on the
  masters in their dtype.  A cast to the masters' own dtype is the leaf
  itself.
- The step's arithmetic is optax's, in the masters' dtype: bf16 masters
  round where optax's bf16 chain rounds (`_guarded_step`).
- `train_batch` packs micro-batches into dense rows (`engines/packing`),
  accumulates the gradients of `loss_fn(per_token_output, batch)` scaled
  by 1 / total loss weight, then takes one guarded optimizer step:
  global-norm clipping, then decoupled AdamW with decay on every leaf,
  at the lr of an optax-semantics schedule (count 0 for the first
  update).  The remat policy (`models/transformer._layer`: "full",
  "dots", "dots_small" or "none") applies to every training forward.
  The step is guarded: a non-finite loss or gradient norm (always), a
  gradient norm above `anomaly_grad_norm_mult` x the running EWMA of
  clean steps' norms (once `anomaly_ewma_warmup` clean steps have been
  seen), an update norm above `anomaly_update_norm_max`, or an
  external trip (the streamed step's batch sentinel) leaves the
  parameters and the optimizer state bit-identical (`torch.where` on a
  device flag, so the step needs no host decision).  The guard's (EWMA,
  clean-step count) pair lives on the device, moves only on clean steps
  and, as in the JAX package, is in no checkpoint.  With the update-norm
  ceiling set, a first pass over the leaves computes the update norm and
  the second recomputes the same update and commits it.  The step's
  scalars and the loss function's stats leave the device in ONE
  transfer per call.
- Streamed accumulation (`train_stream_begin/chunk/end`): each chunk's
  gradients accumulate UNSCALED into `p.grad` (the total loss weight is
  known only when the stream closes); `train_stream_end` scales the sum
  once by 1 / total weight and takes the guarded step.  This equals the
  barrier path's per-micro-batch scaling up to float reassociation; the
  master's overlap window 1 keeps the barrier path bit for bit by never
  streaming.
- A critic config trains its value head the same way: `loss_fn` gets
  the [B, S] fp32 values instead of logprobs.
- `offload()` (`engines/offload.HostOffloadMixin`) moves the masters and
  Adam's `mu`/`nu` to host memory; the next call restores them.
- `save_optimizer_state`/`load_optimizer_state` write and read `mu`,
  `nu` (in the masters' dtype) and the update count (the schedule's and
  Adam's position) as one safetensors file (`models/hf/safetensors_io`),
  a leaf at a time; the round trip is bit for bit.  The format is the
  port's own (the JAX package pickles optax's state).
- The streamed step scales the bf16 gradient sum in place, in bf16; the
  JAX package's fp32 scale promotes the sum and, after it, optax's
  moments to fp32.
- Chaos (`base/faults.py`, ``AREAL_FAULTS``): a due
  ``nan@point=train_grads`` fault scales every gradient by NaN in place,
  on the device, just before the guarded step of `train_batch` and
  `train_stream_end` (`_poison_grads`), so the step's own guard
  quarantines it; the step's one host read stays its only sync.
- Pipeline schedules (a mesh's pipe axis) are not ported.
"""

import math
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model_api import FinetuneSpec, OptimizerConfig
from areal_tpu_torch.base import faults, integrity
from areal_tpu_torch.base.device import resolve_device
from areal_tpu_torch.engines import packing
from areal_tpu_torch.engines.offload import HostOffloadMixin
from areal_tpu_torch.models import transformer as tfm
from areal_tpu_torch.models.config import ModelConfig
from areal_tpu_torch.models.hf import safetensors_io

Params = Dict[str, Any]


def make_lr_schedule(cfg: OptimizerConfig, total_steps: int) -> Callable[[int], float]:
    """count -> lr with optax's semantics: `count` is the number of
    updates already applied (0 for the first), linear warmup from 0 over
    `warmup_steps_proportion` of the steps, then constant, linear decay to
    `lr * min_lr_ratio`, or cosine decay with that floor."""
    warmup = max(int(total_steps * cfg.warmup_steps_proportion), 0)
    floor = cfg.lr * cfg.min_lr_ratio
    decay = max(total_steps - warmup, 1)
    kind = cfg.lr_scheduler_type
    if kind not in ("constant", "linear", "cosine"):
        raise ValueError(f"unknown lr_scheduler_type {kind!r}")

    def main(count: int) -> float:
        frac = min(max(count, 0), decay) / decay
        if kind == "constant":
            return cfg.lr
        if kind == "linear":
            return (cfg.lr - floor) * (1.0 - frac) + floor
        cosine = 0.5 * (1.0 + math.cos(math.pi * frac))
        return cfg.lr * ((1.0 - cfg.min_lr_ratio) * cosine + cfg.min_lr_ratio)

    if warmup == 0:
        return main

    def schedule(count: int) -> float:
        if count < warmup:
            return cfg.lr * max(count, 0) / warmup
        return main(count - warmup)

    return schedule


def _leaves(tree: Params, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _map_tree(fn, tree: Params) -> Params:
    return {
        k: _map_tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()
    }


MASTER_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _master_dtype(dtype) -> torch.dtype:
    """A master dtype given as the JAX package passes it ("float32" /
    "bfloat16") or as a torch dtype."""
    got = MASTER_DTYPES.get(dtype, dtype)
    if got not in MASTER_DTYPES.values():
        raise ValueError(f"master_dtype must be one of {sorted(MASTER_DTYPES)}, got {dtype!r}")
    return got


def _weak(x: float, dtype: torch.dtype) -> float:
    """A Python scalar rounded to `dtype`, as JAX's weak typing rounds
    it before it meets a leaf of that dtype.  torch would compute
    `bf16_leaf * x` with x in fp32 and round once; rounding x first gives
    optax's bf16 product.  A no-op for fp32 leaves."""
    return float(torch.tensor(x, dtype=dtype))


def _global_norm(leaves) -> torch.Tensor:
    """optax.global_norm in the leaves' dtype: each leaf's sum of squares
    (accumulated in fp32 and rounded, as jnp.sum rounds a bf16 sum), the
    leaf sums added in that dtype, the root in that dtype."""
    return torch.sqrt(sum(torch.sum(torch.square(x)) for x in leaves))


def _cast_tree(tree: Params, dtype: torch.dtype) -> Params:
    """Floating leaves to `dtype`, differentiably (the cast's backward
    widens the gradient back to the leaf's dtype)."""
    return _map_tree(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


def model_out(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
              remat) -> torch.Tensor:
    """The per-token model output [B, S] fp32 of a packed batch: a
    critic's values, else next-token logprobs (`per_token_output`)."""
    x = tfm.hidden_states(
        params, cfg, batch["tokens"], batch["segment_ids"],
        positions=batch["positions"], remat=remat,
    )
    return tfm.per_token_output(params, cfg, x, batch["tokens"], batch["segment_ids"])


def device_batch(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A packed batch on `device`.  On the card each array goes through
    pinned memory with a non-blocking copy, so moving a batch never
    synchronises the host with the card (the step's one host read does)."""
    if torch.device(device).type != "cuda":
        return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(device, non_blocking=True)
            for k, v in arrays.items()}


@torch.no_grad()
def forward_sample(
    run: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
    device: torch.device,
    sample: SequenceSample,
    mb_spec: MicroBatchSpec,
    output_key: str,
    token_key: str,
    extra_keys: Sequence[str],
) -> SequenceSample:
    """The engines' forward contract: `run(batch) -> [B, S]` per packed
    micro-batch, re-packed token-aligned under `output_key`, in the
    sample's id order."""
    outs = []
    for mb in sample.split(mb_spec):
        pk = packing.pack_sample(
            mb, token_key, extra_keys=extra_keys,
            max_tokens_per_row=mb_spec.max_tokens_per_mb,
        )
        dense = run(device_batch(pk.arrays, device))
        outs.append(SequenceSample(
            keys={output_key},
            ids=list(mb.ids),
            seqlens={output_key: [list(s) for s in mb.seqlens[token_key]]},
            data={output_key: pk.unpack(dense.float().cpu().numpy())},
        ))
    result = SequenceSample.gather(outs)
    order = {i: n for n, i in enumerate(result.ids)}
    return result.select_idx([order[i] for i in sample.ids])


class TrainEngine(HostOffloadMixin):
    """Master params + AdamW state (fp32 or bf16) on one device."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: Params,
        device=None,
        optimizer_config: Optional[OptimizerConfig] = None,
        ftspec: Optional[FinetuneSpec] = None,
        compute_dtype: torch.dtype = torch.bfloat16,
        # The masters' and Adam's moments' dtype: "float32" (or
        # torch.float32), or "bfloat16", which halves the optimizer's
        # memory (12 -> 6 bytes a parameter) and drops the compute copy.
        master_dtype=torch.float32,
        # Per-layer activation remat: "full", "dots", "dots_small" or
        # "none" (models/transformer._layer).
        remat_policy: str = "full",
        # The tunable sentinels (0 = off): quarantine a step whose grad
        # norm exceeds this multiple (> 1) of the clean steps' EWMA, or
        # whose update norm exceeds this ceiling.
        anomaly_grad_norm_mult: float = 0.0,
        anomaly_update_norm_max: float = 0.0,
        anomaly_ewma_warmup: int = 5,
    ):
        if 0.0 < anomaly_grad_norm_mult <= 1.0:
            raise ValueError(
                "anomaly_grad_norm_mult must be > 1 when set (got "
                f"{anomaly_grad_norm_mult}); 0 disables the spike sentinel"
            )
        if cfg.is_moe:
            raise NotImplementedError("MoE training is not yet ported")
        tfm._remat_layers(remat_policy)  # reject an unknown policy now
        self.master_dtype = _master_dtype(master_dtype)
        self.cfg = cfg
        self.device = resolve_device(device)
        # bf16 products on the CPU are slow and loose: fp32 there, as the
        # JAX package does on its CPU backend.
        self.compute_dtype = torch.float32 if self.device.type == "cpu" else compute_dtype
        self.remat_policy = remat_policy
        self.optimizer_config = optimizer_config or OptimizerConfig()
        self.ftspec = ftspec or FinetuneSpec()
        self.lr_schedule = make_lr_schedule(
            self.optimizer_config, max(self.ftspec.total_train_steps, 1)
        )
        self.set_params(params)
        self._mu = _map_tree(torch.zeros_like, self.params)
        self._nu = _map_tree(torch.zeros_like, self.params)
        self.opt_count = 0  # updates applied (the schedule's and Adam's count)
        self.anomaly_grad_norm_mult = float(anomaly_grad_norm_mult)
        self.anomaly_update_norm_max = float(anomaly_update_norm_max)
        self.anomaly_ewma_warmup = int(anomaly_ewma_warmup)
        # (EWMA of clean steps' grad norms, clean-step count), fp32 on the
        # device; made at the first step.
        self._guard_state: Optional[torch.Tensor] = None
        self._faults = faults.FaultInjector.from_env()
        self.host_transfers = 0
        self.last_pack_stats: Dict[str, float] = {}

    # ---------------- params ----------------

    def get_params(self) -> Params:
        self._ensure_loaded()
        return _map_tree(lambda p: p.detach(), self.params)

    def set_params(self, params: Params) -> None:
        """Replace the masters (copies in the master dtype on the
        engine's device); the optimizer state is kept (restored first if
        offloaded)."""
        self._ensure_loaded()
        self.params = _map_tree(
            lambda x: x.detach().to(self.device, self.master_dtype).clone().requires_grad_(True),
            params,
        )

    # ---------------- optimizer state ----------------

    def save_optimizer_state(self, path: str) -> None:
        """Write Adam's moments (`mu.<leaf>`, `nu.<leaf>`, in the masters'
        dtype) and the update count (metadata `opt_count`) to `path`.  An
        offloaded engine is reloaded first, as every engine call does."""
        self._ensure_loaded()
        tensors = {f"mu.{n}": t for n, t in _leaves(self._mu)}
        tensors.update({f"nu.{n}": t for n, t in _leaves(self._nu)})
        safetensors_io.save_file(tensors, path, metadata={"opt_count": str(self.opt_count)})

    def load_optimizer_state(self, path: str) -> None:
        """Copy the moments and the update count saved by
        `save_optimizer_state` into this engine, bit for bit (the file's
        moments must have the masters' dtype)."""
        self._ensure_loaded()
        header, _ = safetensors_io.read_header(path)
        saved = safetensors_io.load_file(path)
        want = {f"{kind}.{n}" for kind in ("mu", "nu") for n, _ in _leaves(self.params)}
        if set(saved) != want:
            raise ValueError(
                f"{path}: optimizer state for other params (missing "
                f"{sorted(want - set(saved))[:4]}, unexpected {sorted(set(saved) - want)[:4]})"
            )
        wrong = sorted(k for k, t in saved.items() if t.dtype != self.master_dtype)
        if wrong:
            raise ValueError(
                f"{path}: moments in {saved[wrong[0]].dtype}, the engine's masters in "
                f"{self.master_dtype} ({wrong[:4]})"
            )
        with torch.no_grad():
            for kind, tree in (("mu", self._mu), ("nu", self._nu)):
                for n, t in _leaves(tree):
                    t.copy_(saved[f"{kind}.{n}"])
        del saved
        self.opt_count = int(header["__metadata__"]["opt_count"])

    # ---------------- offload (HostOffloadMixin + optimizer state) ----

    def _offload_state(self):
        return (self.params, self._mu, self._nu)

    def _restore_state(self, state) -> None:
        params, self._mu, self._nu = state
        self.params = _map_tree(lambda x: x.requires_grad_(True), params)

    def _drop_state(self) -> None:
        self.params = self._mu = self._nu = None

    # ---------------- steps ----------------

    @torch.no_grad()
    def _guarded_step(self, loss_sum: torch.Tensor, scale: Optional[float] = None,
                      ext_trip: bool = False) -> torch.Tensor:
        """Clip, AdamW, and commit only on a clean verdict with no
        external trip; `scale` multiplies the gradients first (the
        streamed step).  Returns [loss_sum, grad_norm, update_norm,
        verdict] on the device.  The arithmetic is optax's
        (clip_by_global_norm, then adamw's scale_by_adam,
        add_decayed_weights and scale_by_learning_rate, then
        apply_updates) in the masters' dtype: every op rounds to it, and
        each Python scalar is rounded to it first (`_weak`), as JAX's
        weak typing does; the bias corrections are fp32 powers rounded
        to it, the norms `_global_norm`s."""
        oc = self.optimizer_config
        dt = self.master_dtype
        names = [n for n, _ in _leaves(self.params)]
        params = dict(_leaves(self.params))
        mus, nus = dict(_leaves(self._mu)), dict(_leaves(self._nu))
        grads = {
            n: p.grad if p.grad is not None else torch.zeros_like(p)
            for n, p in params.items()
        }
        if scale is not None:  # in place: the gradients die with the step
            for g in grads.values():
                g.mul_(scale)
        gnorm = _global_norm(grads[n] for n in names)
        count = self.opt_count + 1
        f32 = torch.float32
        bc1 = _weak(float(1.0 - torch.tensor(oc.beta1, dtype=f32) ** count), dt)
        bc2 = _weak(float(1.0 - torch.tensor(oc.beta2, dtype=f32) ** count), dt)
        b1, b2 = _weak(oc.beta1, dt), _weak(oc.beta2, dt)
        one_b1, one_b2 = _weak(1.0 - oc.beta1, dt), _weak(1.0 - oc.beta2, dt)
        eps, wd = _weak(oc.eps, dt), _weak(oc.weight_decay, dt)
        neg_lr = _weak(-self.lr_schedule(self.opt_count), dt)
        clip = oc.gradient_clipping

        def adamw(n):
            p, g, mu, nu = params[n], grads[n], mus[n], nus[n]
            if clip and clip > 0:
                g = torch.where(gnorm < _weak(clip, dt), g, g / gnorm * _weak(clip, dt))
            mu_new = one_b1 * g + b1 * mu
            nu_new = one_b2 * torch.square(g) + b2 * nu
            upd = (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + eps)
            return mu_new, nu_new, neg_lr * (upd + wd * p)

        if self._guard_state is None:
            self._guard_state = torch.zeros(2, dtype=torch.float32, device=self.device)
        ewma, n_clean = self._guard_state[0], self._guard_state[1]
        finite = torch.isfinite(gnorm) & torch.isfinite(loss_sum)
        verdict = torch.where(finite, 0.0, float(integrity.NONFINITE))
        if self.anomaly_grad_norm_mult > 0.0:
            # A NaN norm compares False: a non-finite step is not also a spike.
            spike = (n_clean >= self.anomaly_ewma_warmup) & (
                gnorm > self.anomaly_grad_norm_mult * ewma)
            verdict = verdict + torch.where(spike, float(integrity.GRAD_SPIKE), 0.0)
        unorm = None
        if self.anomaly_update_norm_max > 0.0:
            # The ceiling must be judged before anything is written.
            unorm = _global_norm(adamw(n)[2] for n in names)
            ceil = finite & (unorm > _weak(self.anomaly_update_norm_max, dt))
            verdict = verdict + torch.where(ceil, float(integrity.UPDATE_NORM), 0.0)
        ok = verdict == 0.0
        if ext_trip:
            ok = torch.zeros_like(ok)
        usq = None
        for n in names:
            p, mu, nu = params[n], mus[n], nus[n]
            mu_new, nu_new, upd = adamw(n)
            if unorm is None:
                sq = torch.sum(torch.square(upd))
                usq = sq if usq is None else usq + sq
            p.copy_(torch.where(ok, p + upd, p))
            mu.copy_(torch.where(ok, mu_new, mu))
            nu.copy_(torch.where(ok, nu_new, nu))
            p.grad = None
        if unorm is None:
            unorm = torch.sqrt(usq)
        # The EWMA follows CLEAN steps only: a quarantined spike must not
        # drag the baseline up.
        new_ewma = torch.where(
            ok, torch.where(n_clean > 0, 0.9 * ewma + _weak(0.1, dt) * gnorm, gnorm), ewma)
        self._guard_state = torch.stack([new_ewma.float(), n_clean + ok.float()])
        return torch.stack([loss_sum.float(), gnorm.float(), unorm.float(), verdict])

    @torch.no_grad()
    def _poison_grads(self) -> None:
        """The ``nan@point=train_grads`` chaos seam: NaN-scale every
        parameter's accumulated gradient in place, on the device, with no
        host read (a leaf without one gets a NaN gradient)."""
        if self._faults is None or self._faults.poison("train_grads") != "nan":
            return
        for _, p in _leaves(self.params):
            if p.grad is None:
                p.grad = torch.full_like(p, float("nan"))
            else:
                p.grad.mul_(float("nan"))

    def train_batch(
        self,
        sample: SequenceSample,
        mb_spec: MicroBatchSpec,
        loss_fn: Callable,
        loss_weight_fn: Callable[[Dict[str, np.ndarray]], float],
        token_key: str = "packed_input_ids",
        extra_keys: Sequence[str] = (),
    ) -> Dict[str, float]:
        """Accumulate gradients over micro-batches, then one optimizer
        step.  `loss_fn(per_token_output, batch) -> (loss_sum, stats)`
        (logprobs, or a critic's values) returns a SUM over its tokens;
        `loss_weight_fn(arrays)` weighs each micro-batch (e.g. its
        loss-token count), so the gradient is the full-batch mean.  Stats ending in `_sum` are summed and divided by
        the total weight (the suffix dropped); others are averaged."""
        self._ensure_loaded()
        chunks = [
            packing.pack_sample(
                mb, token_key, extra_keys=extra_keys,
                max_tokens_per_row=mb_spec.max_tokens_per_mb,
            ).arrays
            for mb in sample.split(mb_spec)
        ]
        total_weight = max(float(sum(loss_weight_fn(c) for c in chunks)), 1.0)
        real = sum(int((c["segment_ids"] > 0).sum()) for c in chunks)
        grid = sum(int(c["segment_ids"].size) for c in chunks)
        self.last_pack_stats = {
            "real_tokens": real,
            "grid_tokens": grid,
            "pack_efficiency": real / max(grid, 1),
            "n_micro_batches": len(chunks),
        }
        scale = 1.0 / total_weight
        losses, all_stats = [], []
        for _, p in _leaves(self.params):
            p.grad = None
        for arrays in chunks:
            batch = device_batch(arrays, self.device)
            with torch.enable_grad():
                pc = _cast_tree(self.params, self.compute_dtype)
                loss, stats = loss_fn(model_out(pc, self.cfg, batch, self.remat_policy), batch)
                (loss * scale).backward()
            losses.append(loss.detach().float() * scale)
            all_stats.append({k: v.detach().float() for k, v in stats.items()})
        self._poison_grads()
        packed = self._guarded_step(torch.stack(losses).sum())
        keys = list(all_stats[0]) if all_stats else []
        vec = [packed]
        if keys:
            vec.append(torch.stack([
                torch.stack([s[k] for s in all_stats]).sum()
                if k.endswith("_sum")
                else torch.stack([s[k] for s in all_stats]).mean()
                for k in keys
            ]))
        host = torch.cat(vec).double().cpu().numpy()  # the one host sync
        self.host_transfers += 1
        verdict = float(host[3])
        if verdict:
            integrity.record_anomaly(verdict)
        else:
            self.opt_count += 1
        out: Dict[str, float] = {
            "loss": float(host[0]),
            "grad_norm": float(host[1]),
            "update_norm": float(host[2]),
            "anomaly_verdict": verdict,
            "quarantined": 1.0 if verdict else 0.0,
            "n_micro_batches": float(len(chunks)),
        }
        for i, k in enumerate(keys):
            v = float(host[4 + i])
            if k.endswith("_sum"):
                out[k[: -len("_sum")]] = v / total_weight
            else:
                out[k] = v
        return out

    # ---------------- streamed accumulation ----------------
    #
    #   state = engine.train_stream_begin()
    #   for chunk: engine.train_stream_chunk(state, chunk, ...)
    #   out = engine.train_stream_end(state)   # the one optimizer step

    def train_stream_begin(self) -> Dict[str, Any]:
        """Open a streamed accumulation: the gradient sum starts at zero.
        Returns the stream's mutable state."""
        self._ensure_loaded()
        for _, p in _leaves(self.params):
            p.grad = None
        return {
            "loss_sums": [],
            "stat_sums": {},
            "weight": 0.0,
            "n_micro_batches": 0,
            "n_chunks": 0,
            "real_tokens": 0,
            "grid_tokens": 0,
        }

    def train_stream_chunk(
        self,
        state: Dict[str, Any],
        sample: SequenceSample,
        mb_spec: MicroBatchSpec,
        loss_fn: Callable,
        loss_weight_fn: Callable[[Dict[str, np.ndarray]], float],
        token_key: str = "packed_input_ids",
        extra_keys: Sequence[str] = (),
    ) -> Dict[str, float]:
        """Accumulate one chunk's gradients, unscaled, into `p.grad`.
        Returns the chunk's raw stat sums (keys keep their `_sum`
        suffix), `chunk_weight`, `chunk_loss_sum` and
        `chunk_micro_batches`, after one host transfer."""
        self._ensure_loaded()
        chunks = [
            packing.pack_sample(
                mb, token_key, extra_keys=extra_keys,
                max_tokens_per_row=mb_spec.max_tokens_per_mb,
            ).arrays
            for mb in sample.split(mb_spec)
        ]
        chunk_weight = float(sum(loss_weight_fn(c) for c in chunks))
        losses, all_stats = [], []
        for arrays in chunks:
            batch = device_batch(arrays, self.device)
            with torch.enable_grad():
                pc = _cast_tree(self.params, self.compute_dtype)
                loss, stats = loss_fn(model_out(pc, self.cfg, batch, self.remat_policy), batch)
                loss.backward()
            losses.append(loss.detach().float())
            all_stats.append({k: v.detach().float() for k, v in stats.items()})
            state["real_tokens"] += int((arrays["segment_ids"] > 0).sum())
            state["grid_tokens"] += int(arrays["segment_ids"].size)
        chunk_loss, chunk_stats = 0.0, {}
        if losses:
            keys = list(all_stats[0])
            host = torch.stack([torch.stack(losses).sum()] + [
                torch.stack([s[k] for s in all_stats]).sum() for k in keys
            ]).double().cpu().numpy()  # the chunk's one host sync
            self.host_transfers += 1
            chunk_loss = float(host[0])
            chunk_stats = {k: float(host[1 + i]) for i, k in enumerate(keys)}
        state["weight"] += chunk_weight
        state["loss_sums"].append(chunk_loss)
        state["n_micro_batches"] += len(chunks)
        state["n_chunks"] += 1
        for k, v in chunk_stats.items():
            state["stat_sums"][k] = state["stat_sums"].get(k, 0.0) + v
        return {
            **chunk_stats,
            "chunk_weight": chunk_weight,
            "chunk_loss_sum": chunk_loss,
            "chunk_micro_batches": float(len(chunks)),
        }

    def train_stream_end(self, state: Dict[str, Any], quarantine: bool = False) -> Dict[str, float]:
        """Close the stream: scale the gradient sum by 1 / total weight
        and take the guarded step.  `quarantine` (a batch sentinel
        tripped mid-stream) discards the sum: the parameters and the
        optimizer state come back bit-identical."""
        if state["n_chunks"] == 0:
            raise ValueError("train_stream_end before any train_stream_chunk")
        self._ensure_loaded()
        total_weight = max(state["weight"], 1.0)
        loss_sum = torch.full((), sum(state["loss_sums"]), dtype=torch.float32, device=self.device)
        self._poison_grads()
        packed = self._guarded_step(loss_sum, scale=1.0 / total_weight, ext_trip=quarantine)
        self.last_pack_stats = {
            "real_tokens": state["real_tokens"],
            "grid_tokens": state["grid_tokens"],
            "pack_efficiency": state["real_tokens"] / max(state["grid_tokens"], 1),
            "n_micro_batches": state["n_micro_batches"],
        }
        host = packed.double().cpu().numpy()  # the one host sync
        self.host_transfers += 1
        verdict = float(host[3])
        if verdict:
            integrity.record_anomaly(verdict)
        elif not quarantine:
            self.opt_count += 1
        out: Dict[str, float] = {
            "loss": float(sum(state["loss_sums"])) / total_weight,
            "grad_norm": float(host[1]),
            "update_norm": float(host[2]),
            "anomaly_verdict": verdict,
            "quarantined": 1.0 if (verdict or quarantine) else 0.0,
            "n_micro_batches": float(state["n_micro_batches"]),
            "n_stream_chunks": float(state["n_chunks"]),
        }
        for k, v in state["stat_sums"].items():
            if k.endswith("_sum"):
                out[k[: -len("_sum")]] = v / total_weight
            else:
                out[k] = v / max(state["n_micro_batches"], 1)
        return out

    def forward(
        self,
        sample: SequenceSample,
        mb_spec: MicroBatchSpec,
        post_fn: Callable,
        output_key: str,
        token_key: str = "packed_input_ids",
        extra_keys: Sequence[str] = (),
    ) -> SequenceSample:
        """Forward only (`forward_sample`): `post_fn(per_token_output,
        batch) -> [B, S]` per micro-batch, under the current masters cast
        to the compute dtype."""
        self._ensure_loaded()
        with torch.no_grad():
            pc = _cast_tree(self.params, self.compute_dtype)
        return forward_sample(
            lambda b: post_fn(model_out(pc, self.cfg, b, remat=False), b),
            self.device, sample, mb_spec, output_key, token_key, extra_keys,
        )
