"""The SFT interface (port of areal_tpu/interfaces/sft.py): a train step
of the answer-only next-token NLL (`ops/functional.sft_loss`, each
micro-batch weighted by its label count), the evaluation NLL over a
loader's batches, and the checkpoint save, which the PPO actor and
critic save through too."""

import logging
from typing import Dict

import numpy as np
import torch

from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model_api import Model, ModelInterface, register_interface
from areal_tpu_torch.ops import functional as F

logger = logging.getLogger("areal_tpu_torch.sft")


class SFTInterface(ModelInterface):
    def train_step(
        self, model: Model, sample: SequenceSample, mb_spec: MicroBatchSpec
    ) -> Dict[str, float]:
        stats = model.engine.train_batch(
            sample, mb_spec, loss_fn=F.sft_loss, loss_weight_fn=F.sft_label_count,
            token_key="packed_input_ids", extra_keys=("prompt_mask",),
        )
        model.inc_version()
        return stats

    def evaluate(self, model: Model, eval_dataloader) -> Dict[str, float]:
        """The mean answer-token NLL over every batch of the loader."""
        losses, counts = [], []
        for batch in eval_dataloader:
            out = model.engine.forward(
                batch, MicroBatchSpec(), post_fn=_eval_nll_post, output_key="nll",
                token_key="packed_input_ids", extra_keys=("prompt_mask",),
            )
            nll = out.data["nll"]
            losses.append(float(np.sum(nll)))
            counts.append(float(np.sum(nll != 0)))
        return {"eval_nll": sum(losses) / max(sum(counts), 1.0)}

    def save(self, model: Model, save_dir: str) -> None:
        """An HF checkpoint dir of the engine's weights (a TrainEngine's
        fp32 masters), in the model's own family.  On a worker group every
        member gathers the leaves and rank 0 alone writes."""
        from areal_tpu_torch.base.distributed import is_primary
        from areal_tpu_torch.models.hf import registry as hf
        from areal_tpu_torch.system.worker import whole_params

        params = whole_params(model.engine)
        if getattr(model.engine, "mesh", None) is not None and not is_primary():
            return
        hf.save_hf_checkpoint(
            save_dir, model.config, params,
            model_type=hf.infer_model_type(model.config), tokenizer=model.tokenizer,
        )
        logger.info(f"saved checkpoint to {save_dir}")


def _eval_nll_post(logp: torch.Tensor, batch) -> torch.Tensor:
    """Per-token NLL on the positions `sft_loss` counts, 0 elsewhere."""
    mask = F._answer_label_mask(batch["segment_ids"], batch["prompt_mask"])
    return torch.where(mask, -logp, 0.0)


register_interface("sft", SFTInterface)
