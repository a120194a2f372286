"""Training engine (port of areal_tpu/engines/train.py, one device).

- fp32 master parameters and AdamW state on the engine's device; each
  micro-batch casts the masters to the compute dtype (bf16 on the card,
  fp32 on the CPU) INSIDE autograd, so gradients land on the fp32
  masters.
- `train_batch` packs micro-batches into dense rows (`engines/packing`),
  accumulates the gradients of `loss_fn(per_token_output, batch)` scaled
  by 1 / total loss weight, then takes one guarded optimizer step:
  global-norm clipping, then decoupled AdamW with decay on every leaf,
  at the lr of an optax-semantics schedule (count 0 for the first
  update).  A non-finite loss or gradient norm leaves the parameters and
  the optimizer state bit-identical (`torch.where` on a device flag, so
  the step needs no host decision).  The step's scalars and the loss
  function's stats leave the device in ONE transfer per call.
- A critic config trains its value head the same way: `loss_fn` gets
  the [B, S] fp32 values instead of logprobs.
- `offload()` (`engines/offload.HostOffloadMixin`) moves the masters and
  Adam's `mu`/`nu` to host memory; the next call restores them.
- `save_optimizer_state`/`load_optimizer_state` write and read `mu`,
  `nu` and the update count (the schedule's and Adam's position) as one
  safetensors file (`models/hf/safetensors_io`), a leaf at a time; the
  round trip is bit for bit.  The format is the port's own (the JAX
  package pickles optax's state).
- The tunable sentinels (grad-norm spike, update-norm ceiling),
  streamed accumulation and pipeline schedules are not ported.
"""

import math
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model_api import FinetuneSpec, OptimizerConfig
from areal_tpu_torch.base import integrity
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
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


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
    """fp32 master params + AdamW state on one device."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: Params,
        device=None,
        optimizer_config: Optional[OptimizerConfig] = None,
        ftspec: Optional[FinetuneSpec] = None,
        compute_dtype: torch.dtype = torch.bfloat16,
        remat_policy: str = "full",
    ):
        if cfg.is_moe:
            raise NotImplementedError("MoE training is not yet ported")
        tfm._remat_layers(remat_policy)  # reject unknown / unported policies now
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
        self.host_transfers = 0
        self.last_pack_stats: Dict[str, float] = {}

    # ---------------- params ----------------

    def get_params(self) -> Params:
        self._ensure_loaded()
        return _map_tree(lambda p: p.detach(), self.params)

    def set_params(self, params: Params) -> None:
        """Replace the masters (fp32 copies on the engine's device); the
        optimizer state is kept (restored first if offloaded)."""
        self._ensure_loaded()
        self.params = _map_tree(
            lambda x: x.detach().to(self.device, torch.float32).clone().requires_grad_(True),
            params,
        )

    # ---------------- optimizer state ----------------

    def save_optimizer_state(self, path: str) -> None:
        """Write Adam's moments (`mu.<leaf>`, `nu.<leaf>`, fp32) and the
        update count (metadata `opt_count`) to `path`.  An offloaded
        engine is reloaded first, as every engine call does."""
        self._ensure_loaded()
        tensors = {f"mu.{n}": t for n, t in _leaves(self._mu)}
        tensors.update({f"nu.{n}": t for n, t in _leaves(self._nu)})
        safetensors_io.save_file(tensors, path, metadata={"opt_count": str(self.opt_count)})

    def load_optimizer_state(self, path: str) -> None:
        """Copy the moments and the update count saved by
        `save_optimizer_state` into this engine, bit for bit."""
        self._ensure_loaded()
        header, _ = safetensors_io.read_header(path)
        saved = safetensors_io.load_file(path)
        want = {f"{kind}.{n}" for kind in ("mu", "nu") for n, _ in _leaves(self.params)}
        if set(saved) != want:
            raise ValueError(
                f"{path}: optimizer state for other params (missing "
                f"{sorted(want - set(saved))[:4]}, unexpected {sorted(set(saved) - want)[:4]})"
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
    def _guarded_step(self, loss_sum: torch.Tensor) -> torch.Tensor:
        """Clip, AdamW, and commit only when the loss and the gradient
        norm are finite.  Returns [loss_sum, grad_norm, update_norm,
        verdict] on the device."""
        oc = self.optimizer_config
        names = [n for n, _ in _leaves(self.params)]
        params = dict(_leaves(self.params))
        mus, nus = dict(_leaves(self._mu)), dict(_leaves(self._nu))
        grads = {
            n: p.grad if p.grad is not None else torch.zeros_like(p)
            for n, p in params.items()
        }
        gnorm = torch.sqrt(sum(torch.sum(torch.square(grads[n])) for n in names))
        ok = torch.isfinite(gnorm) & torch.isfinite(loss_sum)
        lr = self.lr_schedule(self.opt_count)
        count = self.opt_count + 1
        bc1 = 1.0 - oc.beta1**count
        bc2 = 1.0 - oc.beta2**count
        clip = oc.gradient_clipping
        usq = torch.zeros((), dtype=torch.float32, device=self.device)
        for n in names:
            p, g, mu, nu = params[n], grads[n], mus[n], nus[n]
            if clip and clip > 0:
                g = torch.where(gnorm < clip, g, g / gnorm * clip)
            mu_new = (1.0 - oc.beta1) * g + oc.beta1 * mu
            nu_new = (1.0 - oc.beta2) * torch.square(g) + oc.beta2 * nu
            upd = (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + oc.eps)
            upd = (upd + oc.weight_decay * p) * -lr
            usq += torch.sum(torch.square(upd))
            p.copy_(torch.where(ok, p + upd, p))
            mu.copy_(torch.where(ok, mu_new, mu))
            nu.copy_(torch.where(ok, nu_new, nu))
            p.grad = None
        verdict = torch.where(ok, 0.0, float(integrity.NONFINITE))
        return torch.stack([loss_sum.float(), gnorm.float(), torch.sqrt(usq), verdict])

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
