"""The PPO/GRPO actor and critic (port of `PPOActorInterface`,
`PPOCriticInterface` and their losses in areal_tpu/interfaces/ppo.py).

- generate: group sampling through the generator engine;
- inference: recompute token logprobs (actor; on an `InferenceEngine`
  these are the reference model's) / values (critic, denormalized under
  `value_norm`) with the engine's `forward`;
- train_step: KL-shaped per-token rewards (terminal score, or dense
  per-token scores) -> GAE over each response window with the critic's
  values, or GRPO group-normalized advantages (`disable_value`);
  advantage normalization (over the batch, or per group with a critic);
  then minibatched clipped-PPO updates through `TrainEngine.train_batch`;
  optionally the decoupled objective (`behav_imp_weight_cap`) with a
  proximal forward.  The critic trains its value head on the GAE
  returns (clipped value loss), normalized by running moments under
  `value_norm`.

Both save HF checkpoint dirs (`interfaces/sft.SFTInterface.save`; the
critic's keeps its value head).  The actor's batch sentinels
(`anomaly_kl_max`: the mean |logp - ref_logp| over response tokens;
`anomaly_degenerate_variance`: every GRPO group's scores constant)
judge each batch on host data before any gradient work: a tripped
batch is quarantined whole.  Both interfaces also train streamed
(`train_stream_begin/chunk/end`, the master's pipeline-overlapped
step): each retired rollout chunk's advantages are computed over the
chunk and its gradients accumulate in the engine; the one optimizer
step comes at the stream's end, and a sentinel tripped mid-stream
makes the engine discard the accumulated sum.  `anomaly_imp_ratio_max`
R bounds decoupled PPO's mean behaviour weight exp(prox - old) over the
response tokens to [1/R, R]: a batch outside it is too stale for
clipped updates (asynchronous RL, ROADMAP queue 1 item 7.7).

Alignment (set by the generator): every per-token key is aligned with
packed_input_ids; index t carries the quantity for predicting token t+1.
"""

import dataclasses
import logging
from typing import Dict, Optional

import numpy as np
import torch

from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model_api import (
    GenerationHyperparameters,
    Model,
    ModelInterface,
    register_interface,
)
from areal_tpu_torch.base import integrity
from areal_tpu_torch.base.stats import merge_stats
from areal_tpu_torch.interfaces.kl import make_kl_controller
from areal_tpu_torch.interfaces.sft import SFTInterface
from areal_tpu_torch.interfaces.value_norm import make_value_norm
from areal_tpu_torch.ops.gae import gae_packed

logger = logging.getLogger("areal_tpu_torch.ppo")


def _ppo_actor_loss_factory(
    eps_clip: float, behav_imp_weight_cap: Optional[float] = None
):
    """Clipped-PPO loss over the engine's per-token logprobs [B, S].  With
    `behav_imp_weight_cap` set, the DECOUPLED objective: the proximal
    logprobs (current weights at train-step start) anchor the clipped
    ratio, and the behavior weight exp(prox - old) multiplies each
    token's loss; tokens whose weight exceeds the cap are masked out."""
    decoupled = behav_imp_weight_cap is not None

    def loss_fn(new_logp, batch):
        mask = batch["loss_mask"] > 0
        old_logp = batch["old_logp"]
        adv = batch["advantages"]
        prox_logp = batch["prox_logp"] if decoupled else old_logp
        ratio = torch.exp(torch.where(mask, new_logp - prox_logp, 0.0))
        clipped = torch.clamp(ratio, 1.0 - eps_clip, 1.0 + eps_clip)
        pg = -torch.minimum(ratio * adv, clipped * adv)
        stats = {}
        if decoupled:
            behav = torch.exp(torch.where(mask, prox_logp - old_logp, 0.0))
            capped = mask & (behav > behav_imp_weight_cap)
            pg = pg * torch.where(capped, 0.0, behav)
            stats["behav_imp_weight_sum"] = torch.where(mask, behav, 0.0).sum()
            stats["behav_cap_clip_sum"] = capped.sum().float()
        loss = torch.where(mask, pg, 0.0).sum()
        n_clipped = (mask & (ratio * adv > clipped * adv)).sum()
        stats.update(
            actor_loss_sum=loss,
            importance_weight_sum=torch.where(mask, ratio, 0.0).sum(),
            clip_ratio_sum=n_clipped.float(),
            approx_kl_sum=torch.where(mask, old_logp - new_logp, 0.0).sum(),
            advantage_abs_sum=torch.where(mask, torch.abs(adv), 0.0).sum(),
        )
        return loss, stats

    return loss_fn


def _ppo_critic_loss_factory(value_eps_clip: float):
    """Clipped value loss over the critic's values [B, S] fp32."""

    def loss_fn(values, batch):
        mask = batch["loss_mask"] > 0
        old_v = batch["old_values"]
        ret = batch["returns"]
        v_clip = old_v + torch.clamp(values - old_v, -value_eps_clip, value_eps_clip)
        l1 = torch.square(values - ret)
        l2 = torch.square(v_clip - ret)
        loss = 0.5 * torch.where(mask, torch.maximum(l1, l2), 0.0).sum()
        return loss, {
            "value_loss_sum": loss,
            "value_clip_ratio_sum": (mask & (l2 > l1)).sum().float(),
        }

    return loss_fn


def _logprob_post(logp, batch):
    return logp  # the engine already emits masked next-token logprobs [B, S]


def _value_post(values, batch):
    return torch.where(batch["segment_ids"] > 0, values, 0.0)


def _mask_count(arrays) -> float:
    return float((arrays["loss_mask"] > 0).sum())


def _stream_chunk_stats(raw: Dict[str, float]) -> Dict[str, float]:
    """An engine chunk's raw sums as means over its loss weight, each
    with its `_denominator` (for `merge_stats`)."""
    w = max(raw.pop("chunk_weight"), 1.0)
    stats = {"loss": raw.pop("chunk_loss_sum") / w, "loss_denominator": w}
    raw.pop("chunk_micro_batches", None)
    for k, v in raw.items():
        base = k[: -len("_sum")] if k.endswith("_sum") else k
        stats[base] = v / w
        stats[base + "_denominator"] = w
    return stats


def _extract_layout(sample: SequenceSample):
    """Per-sequence (start, L, prompt_len) and each sequence's group."""
    lens = sample.seqlens_of("packed_input_ids")
    bounds = sample.cu_seqlens("packed_input_ids")
    pmask = np.asarray(sample.data["prompt_mask"])
    layout = []
    for i, L in enumerate(lens):
        s = int(bounds[i])
        layout.append((s, int(L), int(pmask[s : s + L].sum())))
    group_of = []
    for gi, group in enumerate(sample.seqlens["packed_input_ids"]):
        group_of += [gi] * len(group)
    return layout, group_of


def _seq_align_minus1(sample: SequenceSample, key: str) -> np.ndarray:
    """Re-align an (L-1)-per-sequence key to full length L (trailing 0)."""
    src = np.asarray(sample.data[key])
    sb = sample.cu_seqlens(key)
    lens = sample.seqlens_of("packed_input_ids")
    out = np.zeros(sum(lens), np.float32)
    off = 0
    for i, L in enumerate(lens):
        seg = src[sb[i] : sb[i + 1]]
        out[off : off + len(seg)] = seg
        off += L
    return out


def _add_aligned_keys(sample: SequenceSample, arrays: Dict[str, np.ndarray]):
    seqlens = [list(s) for s in sample.seqlens["packed_input_ids"]]
    sample.update_(SequenceSample(
        keys=set(arrays),
        ids=list(sample.ids),
        seqlens={k: [list(s) for s in seqlens] for k in arrays},
        data=dict(arrays),
    ))


def _select_group_seqs(sample: SequenceSample, keep) -> SequenceSample:
    """Keep only sequences `keep[gi]` of each group, for every key with
    one entry per group sequence; other keys pass through whole."""
    k = max(len(g) for g in sample.seqlens["packed_input_ids"])
    new_seqlens, new_data = {}, {}
    for key in sample.keys:
        bounds = sample.cu_seqlens(key)
        arr = np.asarray(sample.data[key])
        slices, new_sl, si = [], [], 0
        for gi, group in enumerate(sample.seqlens[key]):
            idxs = keep[gi] if len(group) == k else range(len(group))
            new_sl.append([group[j] for j in idxs])
            slices += [(int(bounds[si + j]), int(bounds[si + j + 1])) for j in idxs]
            si += len(group)
        new_data[key] = (
            np.concatenate([arr[a:b] for a, b in slices]) if slices else arr[:0]
        )
        new_seqlens[key] = new_sl
    return SequenceSample(
        keys=set(sample.keys),
        ids=list(sample.ids),
        seqlens=new_seqlens,
        data=new_data,
        metadata={k: list(v) for k, v in sample.metadata.items()},
    )


def _response_gae(layout, seq_slices, rewards, values, no_eos, gamma, lam, device):
    """GAE over each sequence's response window [lo, hi), the windows
    packed end to end.  A window's bootstrap is the value at its
    sequence's LAST token times `seq_no_eos_mask`: 0 for a sequence that
    ended with EOS, V(s_L) for a truncated one.  Runs on `device`;
    returns (advantages, returns) full-length aligned, 0 off the windows."""
    total = len(rewards)
    adv_full = np.zeros(total, np.float32)
    ret_full = np.zeros(total, np.float32)
    parts = []
    for si, (lo, hi) in enumerate(seq_slices):
        n = hi - lo
        if n == 0:
            continue
        s, L, _ = layout[si]
        boot = np.zeros(n, np.float32)
        boot[-1] = no_eos[si] * values[s + L - 1]
        parts.append((rewards[lo:hi], values[lo:hi], np.full(n, si + 1, np.int32), boot))
    if not parts:
        return adv_full, ret_full
    r, v, seg, boot = (
        torch.from_numpy(np.concatenate(col)).to(device) for col in zip(*parts)
    )
    adv, ret = torch.stack(gae_packed(r, v, seg, boot, gamma, lam)).cpu().numpy()
    off = 0
    for lo, hi in seq_slices:
        adv_full[lo:hi] = adv[off : off + hi - lo]
        ret_full[lo:hi] = ret[off : off + hi - lo]
        off += hi - lo
    return adv_full, ret_full


@dataclasses.dataclass
class PPOActorInterface(ModelInterface):
    gconfig: GenerationHyperparameters = dataclasses.field(
        default_factory=GenerationHyperparameters
    )
    n_minibatches: int = 4
    eps_clip: float = 0.2
    kl_ctl: float = 0.0
    kl_adaptive: bool = False
    adaptive_kl_target: float = 6.0
    adaptive_kl_horizon: float = 10000.0
    # Best-of-k: sample `generation_size` responses per prompt, train on
    # the top `gconfig.n` by reward (ties toward longer responses).
    generation_size: Optional[int] = None
    discount: float = 1.0
    gae_lambda: float = 1.0
    max_reward_clip: float = 5.0
    reward_scaling: float = 1.0
    reward_bias: float = 0.0
    early_stop_imp_ratio: Optional[float] = None
    early_stop_kl: Optional[float] = None
    disable_value: bool = False  # GRPO mode: no critic
    adv_norm: bool = True
    group_adv_norm: bool = False  # acts only with the critic
    mask_no_eos_with_zero: bool = False
    # Per-token rewards (value mode only): key "dense_rewards", one score
    # per token aligned with packed_input_ids, in place of the terminal
    # scalar; reward_delta earns consecutive-score differences instead.
    use_dense_reward: bool = False
    reward_delta: bool = True
    behav_imp_weight_cap: Optional[float] = None
    # Batch sentinels, judged before any gradient work (None / False:
    # off).  anomaly_imp_ratio_max judges only a decoupled batch (one
    # with proximal logprobs).
    anomaly_kl_max: Optional[float] = None
    anomaly_imp_ratio_max: Optional[float] = None
    anomaly_degenerate_variance: bool = False

    def __post_init__(self):
        self._kl_ctl = make_kl_controller(
            self.kl_ctl, self.kl_adaptive, self.adaptive_kl_target,
            self.adaptive_kl_horizon,
        )
        self._loss_fn = _ppo_actor_loss_factory(self.eps_clip, self.behav_imp_weight_cap)

    def _batch_verdict(self, aux) -> int:
        """OR of the batch sentinels' verdict bits (0: clean)."""
        v = 0
        kl = aux.get("kl_abs_mean")
        if self.anomaly_kl_max is not None and kl is not None and kl > self.anomaly_kl_max:
            v |= integrity.KL_BLOWUP
        r = aux.get("behav_imp_mean")
        if self.anomaly_imp_ratio_max is not None and r is not None:
            cap = self.anomaly_imp_ratio_max
            if not 1.0 / cap <= r <= cap:
                v |= integrity.IMP_RATIO
        if self.anomaly_degenerate_variance and aux.get("degenerate_var"):
            v |= integrity.DEGENERATE_VAR
        return v

    def state_dict(self) -> Dict[str, float]:
        return self._kl_ctl.state_dict() if self.kl_adaptive else {}

    def load_state_dict(self, sd) -> None:
        if self.kl_adaptive and sd:
            self._kl_ctl.load_state_dict(sd)

    def generate(
        self, model: Model, sample: SequenceSample, mb_spec: MicroBatchSpec
    ) -> SequenceSample:
        g = self.gconfig
        if self.generation_size is not None:
            if self.generation_size < g.n:
                raise ValueError(
                    f"generation_size={self.generation_size} must be >= "
                    f"group size n={g.n}"
                )
            g = dataclasses.replace(g, n=self.generation_size)
        return model.engine.generate(
            sample, mb_spec, g, prompt_key="packed_prompts", seed=model.version,
        )

    def inference(
        self, model: Model, sample: SequenceSample, mb_spec: MicroBatchSpec
    ) -> SequenceSample:
        return model.engine.forward(
            sample, mb_spec, post_fn=_logprob_post, output_key="logprobs",
            token_key="packed_input_ids",
        )

    def _filter_best_of_k(self, sample: SequenceSample) -> SequenceSample:
        scores = np.asarray(sample.data["rewards"], np.float32)
        layout, _ = _extract_layout(sample)
        keep, si = [], 0
        for group in sample.seqlens["packed_input_ids"]:
            k = len(group)
            resp_lens = [layout[si + j][1] - layout[si + j][2] for j in range(k)]
            order = sorted(
                range(k), key=lambda j: (scores[si + j], resp_lens[j]), reverse=True,
            )[: self.gconfig.n]
            keep.append(sorted(order))
            si += k
        return _select_group_seqs(sample, keep)

    def _prepare_train_sample(
        self, model: Model, sample: SequenceSample, mb_spec: MicroBatchSpec
    ):
        """Best-of-k filtering, KL-shaped rewards, GAE (with the critic's
        `values`) or GRPO advantages, advantage normalization, and the
        packed train sample with its aligned keys.  Returns
        (train_sample, extra_keys, aux)."""
        if self.generation_size is not None and self.generation_size > self.gconfig.n:
            sample = self._filter_best_of_k(sample)
        klv = self._kl_ctl.value
        # The sharded data plane: the heavy per-token inputs are real only
        # for this member's own rows (the layout and the per-sequence keys
        # are whole).  Per-row math stays the same on every member; the
        # batch-global statistics (the advantage moments of a batch
        # `adv_norm`, the policy-ref KL) come from the engine's exact
        # reduction over the placed rows (`masked_moments`), the same on
        # every member, so the adaptive KL controller moves in lockstep.
        sharded = sample.shard_blocks() is not None
        layout, group_of = _extract_layout(sample)
        total = sum(L for (_, L, _) in layout)

        old_logp = _seq_align_minus1(sample, "packed_logprobs")
        prox_logp = None
        if self.behav_imp_weight_cap is not None:
            # One forward under the CURRENT weights, before any update, so
            # every minibatch shares the same anchor.
            prox_out = model.engine.forward(
                sample.select_keys({"packed_input_ids"}), mb_spec,
                post_fn=_logprob_post, output_key="prox_logp",
                token_key="packed_input_ids",
            )
            prox_logp = np.asarray(prox_out.data["prox_logp"], np.float32)
        ref_logp = (
            _seq_align_minus1(sample, "packed_ref_logprobs")
            if "packed_ref_logprobs" in sample.keys
            else None
        )
        scores = np.asarray(sample.data["rewards"], np.float32).copy()
        scores = np.clip(
            (scores + self.reward_bias) * self.reward_scaling,
            -self.max_reward_clip, self.max_reward_clip,
        )
        no_eos = np.asarray(sample.data["seq_no_eos_mask"], np.float32)
        if self.mask_no_eos_with_zero:
            scores = scores * (1.0 - no_eos)
        dense = None
        if self.use_dense_reward:
            if self.disable_value:
                raise ValueError(
                    "use_dense_reward requires the value (critic) mode: GRPO "
                    "group advantages are defined on scalar scores"
                )
            if "dense_rewards" not in sample.keys:
                raise ValueError(
                    "use_dense_reward needs a 'dense_rewards' key (one score "
                    "per token, aligned with packed_input_ids)"
                )
            dense = np.asarray(sample.data["dense_rewards"], np.float32)
            if len(dense) != total:
                raise ValueError(
                    f"dense_rewards must align with packed_input_ids: got "
                    f"{len(dense)} scores for {total} tokens"
                )
            dense = np.clip(
                (dense + self.reward_bias) * self.reward_scaling,
                -self.max_reward_clip, self.max_reward_clip,
            )

        # Loss positions t in [pl-1, L-2]: each predicts a response token.
        loss_mask = np.zeros(total, np.float32)
        seq_slices = []
        for s, L, pl in layout:
            lo, hi = s + max(pl - 1, 0), s + L - 1
            loss_mask[lo:hi] = 1.0
            seq_slices.append((lo, hi))

        degenerate_var = None
        if self.disable_value:
            # GRPO: the group-normalized terminal score over the response.
            groups: Dict[int, list] = {}
            for si in range(len(layout)):
                groups.setdefault(group_of[si], []).append(si)
            adv_seq = np.zeros(len(layout), np.float32)
            degenerate_var = len(groups) > 0
            for sis in groups.values():
                g_scores = scores[sis]
                if g_scores.std() > 0:
                    degenerate_var = False
                adv_seq[sis] = (g_scores - g_scores.mean()) / (g_scores.std() + 1e-5)
            adv_full = np.zeros(total, np.float32)
            for si, (lo, hi) in enumerate(seq_slices):
                adv_full[lo:hi] = adv_seq[si]
            if ref_logp is not None and klv != 0.0:
                adv_full += -klv * (old_logp - ref_logp) * loss_mask
        else:
            # Per-token rewards: the KL penalty on every response token,
            # plus the terminal score at the last one (or, dense, token
            # t+1's score or its delta at transition t); then GAE with
            # the critic's values.
            rewards = np.zeros(total, np.float32)
            if ref_logp is not None and klv != 0.0:
                rewards -= klv * (old_logp - ref_logp)
            for si, (lo, hi) in enumerate(seq_slices):
                if dense is not None:
                    gain = dense[lo + 1 : hi + 1]
                    if self.reward_delta:
                        gain = gain - dense[lo:hi]
                    if self.mask_no_eos_with_zero:
                        gain = gain * (1.0 - no_eos[si])
                    rewards[lo:hi] += gain
                elif hi > lo:
                    rewards[hi - 1] += scores[si]
            rewards *= loss_mask
            values = (
                np.asarray(sample.data["values"], np.float32)
                if "values" in sample.keys
                else np.zeros(total, np.float32)
            )
            adv_full, _ = _response_gae(
                layout, seq_slices, rewards, values, no_eos,
                self.discount, self.gae_lambda, model.engine.device,
            )

        # Normalized over the whole batch, or per group with a critic
        # (`group_adv_norm` does not act on GRPO advantages, which are
        # group-normalized already).  Sharded, the batch moments and the
        # ref-KL come from one `masked_moments` pass.
        ref_kl = None
        batch_norm = self.adv_norm and not (self.group_adv_norm and not self.disable_value)
        if sharded and (batch_norm or ref_logp is not None):
            probe = sample.select_keys({"packed_input_ids"})
            arrays = {"loss_mask": loss_mask}
            vkeys = []
            if batch_norm:
                arrays["adv_probe"] = adv_full
                vkeys.append("adv_probe")
            if ref_logp is not None:
                arrays["klterm"] = (old_logp - ref_logp) * loss_mask
                vkeys.append("klterm")
            _add_aligned_keys(probe, arrays)
            mom = model.engine.masked_moments(probe, mb_spec, vkeys, mask_key="loss_mask")
            cnt = mom["count"]
            if batch_norm and cnt > 0:
                s_, ssq, _ = mom["adv_probe"]
                mean = s_ / cnt
                std = float(np.sqrt(max(ssq / cnt - mean * mean, 0.0)))
                mk = loss_mask > 0
                adv_full[mk] = (adv_full[mk] - mean) / (std + 1e-5)
            if ref_logp is not None and cnt > 0:
                ref_kl = float(mom["klterm"][0] / cnt)
        m = loss_mask > 0
        if self.adv_norm:
            if not batch_norm:
                # Per group: a group is one batch element, never split
                # across shards, so each member normalizes its own rows.
                for gi in set(group_of):
                    gm = np.zeros_like(m)
                    for si, (lo, hi) in enumerate(seq_slices):
                        if group_of[si] == gi:
                            gm[lo:hi] = m[lo:hi]
                    if gm.any():
                        vals = adv_full[gm]
                        adv_full[gm] = (vals - vals.mean()) / (vals.std() + 1e-5)
            elif not sharded and m.any():
                vals = adv_full[m]
                adv_full[m] = (vals - vals.mean()) / (vals.std() + 1e-5)

        train_sample = sample.select_keys({"packed_input_ids", "prompt_mask"})
        aligned = {"old_logp": old_logp, "advantages": adv_full, "loss_mask": loss_mask}
        extra_keys = ("old_logp", "advantages", "loss_mask")
        if prox_logp is not None:
            aligned["prox_logp"] = prox_logp
            extra_keys = extra_keys + ("prox_logp",)
        _add_aligned_keys(train_sample, aligned)
        mt = float(loss_mask.sum())
        kl_abs_mean = None
        if ref_logp is not None and mt > 0:
            kl_abs_mean = float((np.abs(old_logp - ref_logp) * loss_mask).sum() / mt)
        behav_imp_mean = None
        if prox_logp is not None and mt > 0:
            behav_imp_mean = float(
                (np.exp((prox_logp - old_logp) * loss_mask) * loss_mask).sum() / mt
            )
        aux = {
            "klv": klv,
            "n_seqs": len(layout),
            "loss_mask": loss_mask,
            "old_logp": old_logp,
            "ref_logp": ref_logp,
            "scores": scores,
            "no_eos": no_eos,
            "ref_kl": ref_kl,
            "kl_abs_mean": kl_abs_mean,
            "behav_imp_mean": behav_imp_mean,
            "degenerate_var": degenerate_var,
        }
        return train_sample, extra_keys, aux

    def train_step(
        self, model: Model, sample: SequenceSample, mb_spec: MicroBatchSpec
    ) -> Dict[str, float]:
        train_sample, extra_keys, aux = self._prepare_train_sample(
            model, sample, mb_spec
        )
        loss_mask, old_logp, ref_logp = aux["loss_mask"], aux["old_logp"], aux["ref_logp"]
        verdict = self._batch_verdict(aux)
        if verdict:
            # Quarantined before any gradient work: no minibatch of this
            # batch reaches the optimizer.
            integrity.record_anomaly(verdict)
            logger.warning(
                f"batch sentinel quarantined train step: {integrity.verdict_kinds(verdict)} "
                f"(kl_abs_mean={aux['kl_abs_mean']} behav_imp_mean={aux['behav_imp_mean']} "
                f"degenerate_var={aux['degenerate_var']})"
            )
            model.inc_version()
            return {
                "anomaly_verdict": float(verdict),
                "quarantined": 1.0,
                "task_reward": float(aux["scores"].mean()),
                "no_eos_ratio": float(aux["no_eos"].mean()),
                "n_response_tokens": float(loss_mask.sum()),
                "kl_ctl_value": aux["klv"],
                "n_minibatches_skipped": float(min(self.n_minibatches, train_sample.bs)),
            }
        all_stats, n_skipped = [], 0
        mbs_list = train_sample.split_balanced(min(self.n_minibatches, train_sample.bs))
        for mi, mb in enumerate(mbs_list):
            stats = model.engine.train_batch(
                mb, mb_spec, loss_fn=self._loss_fn, loss_weight_fn=_mask_count,
                token_key="packed_input_ids", extra_keys=extra_keys,
            )
            all_stats.append(stats)
            imp = stats.get("importance_weight", 1.0)
            akl = abs(stats.get("approx_kl", 0.0))
            if (
                self.early_stop_imp_ratio is not None and imp > self.early_stop_imp_ratio
            ) or (self.early_stop_kl is not None and akl > self.early_stop_kl):
                n_skipped = len(mbs_list) - (mi + 1)
                logger.warning(
                    f"early stop after minibatch {mi + 1}/{len(mbs_list)}: "
                    f"importance_weight={imp:.3f} approx_kl={akl:.4f}; "
                    f"skipping {n_skipped} minibatches"
                )
                break
        model.inc_version()

        out = {k: float(np.mean([s[k] for s in all_stats])) for k in all_stats[0]}
        # Sharded, ref_kl was reduced over the mesh above (the host formula
        # would read the other members' zero-filled rows).
        ref_kl = aux["ref_kl"]
        if ref_kl is None:
            ref_kl = 0.0
            if ref_logp is not None and loss_mask.sum() > 0:
                ref_kl = float(((old_logp - ref_logp) * loss_mask).sum() / loss_mask.sum())
        if ref_logp is not None and loss_mask.sum() > 0:
            self._kl_ctl.update(ref_kl, n_steps=aux["n_seqs"])
        out.update(
            task_reward=float(aux["scores"].mean()),
            no_eos_ratio=float(aux["no_eos"].mean()),
            n_response_tokens=float(loss_mask.sum()),
            kl_ctl_value=aux["klv"],
            ref_kl=ref_kl,
            n_minibatches_skipped=float(n_skipped),
        )
        return out

    # ------------- streamed (pipeline-overlapped) train -------------

    def train_stream_begin(self, model: Model, mb_spec: MicroBatchSpec) -> Dict:
        """Open a streamed train step: chunks arrive through
        `train_stream_chunk` as their rollouts retire, and the one
        optimizer step fires in `train_stream_end`."""
        return {
            "engine": model.engine.train_stream_begin(),
            "chunk_stats": [],
            "kl_num": 0.0,
            "kl_den": 0.0,
            "n_seqs": 0,
            "score_sum": 0.0,
            "score_n": 0,
            "no_eos_sum": 0.0,
            "no_eos_n": 0,
            "resp_tokens": 0.0,
            "klv": self._kl_ctl.value,
            "stopped": False,
            "n_chunks_skipped": 0,
            # A batch sentinel's trip: stop accumulating, and make the
            # engine discard the partial sum at the stream's end.
            "quarantine_verdict": 0,
        }

    def train_stream_chunk(
        self, model: Model, state: Dict, sample: SequenceSample, mb_spec: MicroBatchSpec
    ) -> Dict[str, float]:
        """One retired chunk: its advantages (normalized over the chunk)
        and its gradients.  Returns the chunk's stats with `*_denominator`
        weights, so `merge_stats` gives the step's token-weighted means."""
        if state["stopped"]:
            state["n_chunks_skipped"] += 1
            return {"n_chunks_skipped": 1.0}
        if sample.shard_blocks() is not None:
            raise ValueError("pipeline overlap does not compose with shard-exact dispatch; "
                             "chunk inputs must go to every member whole")
        train_sample, extra_keys, aux = self._prepare_train_sample(model, sample, mb_spec)
        verdict = self._batch_verdict(aux)
        if verdict:
            state["stopped"] = True
            state["quarantine_verdict"] |= verdict
            state["n_chunks_skipped"] += 1
            integrity.record_anomaly(verdict)
            logger.warning(
                f"batch sentinel quarantined stream chunk {len(state['chunk_stats']) + 1}: "
                f"{integrity.verdict_kinds(verdict)}; the step's accumulated gradient "
                "will be discarded"
            )
            return {"n_chunks_skipped": 1.0, "anomaly_verdict": float(verdict)}
        stats = _stream_chunk_stats(model.engine.train_stream_chunk(
            state["engine"], train_sample, mb_spec, loss_fn=self._loss_fn,
            loss_weight_fn=_mask_count, token_key="packed_input_ids", extra_keys=extra_keys,
        ))
        loss_mask, old_logp, ref_logp = aux["loss_mask"], aux["old_logp"], aux["ref_logp"]
        mt = float(loss_mask.sum())
        if ref_logp is not None and mt > 0:
            state["kl_num"] += float(((old_logp - ref_logp) * loss_mask).sum())
            state["kl_den"] += mt
        state["n_seqs"] += aux["n_seqs"]
        state["score_sum"] += float(aux["scores"].sum())
        state["score_n"] += len(aux["scores"])
        state["no_eos_sum"] += float(aux["no_eos"].sum())
        state["no_eos_n"] += len(aux["no_eos"])
        state["resp_tokens"] += mt
        state["chunk_stats"].append(stats)
        imp = stats.get("importance_weight", 1.0)
        akl = abs(stats.get("approx_kl", 0.0))
        if (
            self.early_stop_imp_ratio is not None and imp > self.early_stop_imp_ratio
        ) or (self.early_stop_kl is not None and akl > self.early_stop_kl):
            state["stopped"] = True
            logger.warning(
                f"early stop after stream chunk {len(state['chunk_stats'])}: "
                f"importance_weight={imp:.3f} approx_kl={akl:.4f}; the remaining "
                "chunks accumulate no gradient"
            )
        return stats

    def train_stream_end(self, model: Model, state: Dict, mb_spec: MicroBatchSpec) -> Dict[str, float]:
        """The one optimizer step over the streamed sum, and the merged stats."""
        verdict = int(state["quarantine_verdict"])
        if verdict and state["engine"]["n_chunks"] == 0:
            # Tripped before any chunk reached the engine: nothing to
            # discard, no optimizer step.
            eng_out: Dict[str, float] = {
                "grad_norm": 0.0, "update_norm": 0.0, "n_micro_batches": 0.0,
                "n_stream_chunks": 0.0,
            }
        else:
            eng_out = model.engine.train_stream_end(state["engine"], quarantine=bool(verdict))
        model.inc_version()
        out = merge_stats(state["chunk_stats"]) if state["chunk_stats"] else {}
        # The engine's totals win for the keys both report.
        out.update(eng_out)
        if verdict:
            out["anomaly_verdict"] = float(int(out.get("anomaly_verdict", 0.0)) | verdict)
            out["quarantined"] = 1.0
        ref_kl = 0.0
        if state["kl_den"] > 0:
            ref_kl = state["kl_num"] / state["kl_den"]
            self._kl_ctl.update(ref_kl, n_steps=state["n_seqs"])
        out.update(
            task_reward=state["score_sum"] / max(state["score_n"], 1),
            no_eos_ratio=state["no_eos_sum"] / max(state["no_eos_n"], 1),
            n_response_tokens=state["resp_tokens"],
            kl_ctl_value=state["klv"],
            ref_kl=ref_kl,
            n_minibatches_skipped=float(state["n_chunks_skipped"]),
        )
        return out

    def save(self, model: Model, save_dir: str) -> None:
        SFTInterface().save(model, save_dir)


@dataclasses.dataclass
class PPOCriticInterface(ModelInterface):
    n_minibatches: int = 4
    value_eps_clip: float = 0.2
    discount: float = 1.0
    gae_lambda: float = 1.0
    max_reward_clip: float = 5.0
    kl_ctl: float = 0.0
    # Running mean/std normalization of the returns: the head learns
    # normalized targets, and `inference` denormalizes its predictions.
    value_norm: bool = False
    value_norm_type: str = "exp"  # "exp" | "ma"
    value_norm_beta: float = 0.99995
    value_norm_eps: float = 1e-5

    def __post_init__(self):
        self._loss_fn = _ppo_critic_loss_factory(self.value_eps_clip)
        self.rms = (
            make_value_norm(self.value_norm_type, self.value_norm_beta, self.value_norm_eps)
            if self.value_norm
            else None
        )

    def state_dict(self) -> Dict[str, float]:
        # A restored head trained on normalized targets needs its moments,
        # or inference would denormalize with the identity.
        return self.rms.state_dict() if self.value_norm else {}

    def load_state_dict(self, sd) -> None:
        if self.value_norm and sd:
            self.rms.load_state_dict(sd)

    def save(self, model: Model, save_dir: str) -> None:
        # The trained value head goes into the checkpoint too
        # (`value_head.weight`), so a critic reloads as it was saved.
        SFTInterface().save(model, save_dir)

    def train_stream_begin(self, model: Model, mb_spec: MicroBatchSpec) -> Dict:
        return {"engine": model.engine.train_stream_begin(), "chunk_stats": []}

    def train_stream_chunk(
        self, model: Model, state: Dict, sample: SequenceSample, mb_spec: MicroBatchSpec
    ) -> Dict[str, float]:
        """One retired chunk's returns (the value-norm moments updated
        with the chunk's) and its gradients."""
        if sample.shard_blocks() is not None:
            raise ValueError("pipeline overlap does not compose with shard-exact dispatch; "
                             "chunk inputs must go to every member whole")
        train_sample = self._prepare_train_sample(model, sample, mb_spec)
        stats = _stream_chunk_stats(model.engine.train_stream_chunk(
            state["engine"], train_sample, mb_spec, loss_fn=self._loss_fn,
            loss_weight_fn=_mask_count, token_key="packed_input_ids",
            extra_keys=("old_values", "returns", "loss_mask"),
        ))
        state["chunk_stats"].append(stats)
        return stats

    def train_stream_end(self, model: Model, state: Dict, mb_spec: MicroBatchSpec) -> Dict[str, float]:
        eng_out = model.engine.train_stream_end(state["engine"])
        model.inc_version()
        out = merge_stats(state["chunk_stats"]) if state["chunk_stats"] else {}
        out.update(eng_out)
        return out

    def inference(
        self, model: Model, sample: SequenceSample, mb_spec: MicroBatchSpec
    ) -> SequenceSample:
        out = model.engine.forward(
            sample, mb_spec, post_fn=_value_post, output_key="values",
            token_key="packed_input_ids",
        )
        if self.value_norm:
            # Hand real-scale values to the consumers (the actor's GAE and
            # this interface's own train_step).
            out.data["values"] = self.rms.denormalize(
                np.asarray(out.data["values"], np.float32)
            )
        return out

    def _prepare_train_sample(
        self, model: Model, sample: SequenceSample, mb_spec: MicroBatchSpec
    ) -> SequenceSample:
        """KL-shaped rewards -> GAE returns -> (under value_norm: the
        running moments updated with this batch's returns, then returns
        and old values normalized) -> the packed train sample."""
        layout, _ = _extract_layout(sample)
        total = sum(L for (_, L, _) in layout)
        old_logp = _seq_align_minus1(sample, "packed_logprobs")
        ref_logp = (
            _seq_align_minus1(sample, "packed_ref_logprobs")
            if "packed_ref_logprobs" in sample.keys
            else None
        )
        values = np.asarray(sample.data["values"], np.float32)
        scores = np.clip(
            np.asarray(sample.data["rewards"], np.float32),
            -self.max_reward_clip, self.max_reward_clip,
        )
        no_eos = np.asarray(sample.data["seq_no_eos_mask"], np.float32)

        rewards = np.zeros(total, np.float32)
        loss_mask = np.zeros(total, np.float32)
        if ref_logp is not None and self.kl_ctl != 0.0:
            rewards -= self.kl_ctl * (old_logp - ref_logp)
        seq_slices = []
        for si, (s, L, pl) in enumerate(layout):
            lo, hi = s + max(pl - 1, 0), s + L - 1
            loss_mask[lo:hi] = 1.0
            if hi > lo:
                rewards[hi - 1] += scores[si]
            seq_slices.append((lo, hi))
        rewards *= loss_mask
        _, returns = _response_gae(
            layout, seq_slices, rewards, values, no_eos,
            self.discount, self.gae_lambda, model.engine.device,
        )
        if self.value_norm:
            # The old values are normalized too, so the clip window lives
            # in the targets' space.  Sharded, the host returns are wrong
            # on the other members' rows (their values are zero-filled):
            # the batch moments come from the engine's reduction over the
            # placed rows, the same on every member.
            if sample.shard_blocks() is not None:
                probe = sample.select_keys({"packed_input_ids"})
                _add_aligned_keys(probe, {"ret_probe": returns, "loss_mask": loss_mask})
                mom = model.engine.masked_moments(probe, mb_spec, ("ret_probe",),
                                                  mask_key="loss_mask")
                cnt = mom["count"]
                if cnt > 0:
                    s_, ssq, _ = mom["ret_probe"]
                    self.rms.update_moments(s_ / cnt, ssq / cnt, cnt)
            else:
                self.rms.update(returns, mask=loss_mask)
            returns = self.rms.normalize(returns)
            values = self.rms.normalize(values)

        train_sample = sample.select_keys({"packed_input_ids", "prompt_mask"})
        _add_aligned_keys(train_sample, {
            "old_values": values, "returns": returns, "loss_mask": loss_mask,
        })
        return train_sample

    def train_step(
        self, model: Model, sample: SequenceSample, mb_spec: MicroBatchSpec
    ) -> Dict[str, float]:
        train_sample = self._prepare_train_sample(model, sample, mb_spec)
        all_stats = [
            model.engine.train_batch(
                mb, mb_spec, loss_fn=self._loss_fn, loss_weight_fn=_mask_count,
                token_key="packed_input_ids",
                extra_keys=("old_values", "returns", "loss_mask"),
            )
            for mb in train_sample.split_balanced(min(self.n_minibatches, train_sample.bs))
        ]
        model.inc_version()
        return {k: float(np.mean([s[k] for s in all_stats])) for k in all_stats[0]}


register_interface("ppo_actor", PPOActorInterface)
register_interface("ppo_critic", PPOCriticInterface)
