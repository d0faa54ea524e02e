"""Blip2NemotronH: the 3D-LLM's scene path (``models/blip2_lfm2.py``) in
front of a Nemotron-H language model (``models/nemotron_h.py``), through a
linear ``nemotron_proj`` from the Q-Former's width to the LM's. Greedy
answers come from ``blip2_lfm2.predict_answers``, whose decode steps replay
as captured CUDA graphs on a card, over the LM's conv, SSM and KV states."""
from __future__ import annotations

import torch

from situation3d_tpu_torch.models.blip2_lfm2 import Blip2Decoder
from situation3d_tpu_torch.models.nemotron_h import NemotronHConfig, NemotronHForCausalLM
from situation3d_tpu_torch.utils.registry import registry


@registry.register_model("blip2_nemotron_h")
class Blip2NemotronH(Blip2Decoder):
    lm_name, proj_name = "nemotron_h", "nemotron_proj"

    @staticmethod
    def make_lm(cfg: NemotronHConfig, dtype: torch.dtype, param_dtype: torch.dtype
                ) -> NemotronHForCausalLM:
        return NemotronHForCausalLM(cfg, dtype, param_dtype)
