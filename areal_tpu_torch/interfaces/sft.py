"""The SFT interface's checkpoint save (port of `SFTInterface.save` in
areal_tpu/interfaces/sft.py), which the PPO actor and critic save
through.  SFT's train step, its loss and evaluation are not yet ported
(ROADMAP queue 1, item 6)."""

import logging

from areal_tpu_torch.api.model_api import Model, ModelInterface

logger = logging.getLogger("areal_tpu_torch.sft")


class SFTInterface(ModelInterface):
    def save(self, model: Model, save_dir: str) -> None:
        """An HF checkpoint dir of the engine's weights (a TrainEngine's
        fp32 masters), in the model's own family."""
        from areal_tpu_torch.models.hf import registry as hf

        hf.save_hf_checkpoint(
            save_dir, model.config, model.engine.get_params(),
            model_type=hf.infer_model_type(model.config), tokenizer=model.tokenizer,
        )
        logger.info(f"saved checkpoint to {save_dir}")
