"""Multi-question scene-QA serving with scene-encoding reuse (port of
``situation3d_tpu/eval/serving.py``).

SQA3D asks several questions per scene. The expensive half of SIG3D — plan
build + MinkUNet + situated token pooling — runs once per scene
(:meth:`SceneCache.encode`), and each question reuses the pooled
``scene_tokens`` through the model's ``scene_tokens`` fast path: per-question
work drops to the language encoder + MCAN fusion + heads.

Exactness: answers equal the full forward's given the same sampled tokens
(the tokens ARE the full forward's pooled tokens; a test asserts it).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from situation3d_tpu_torch.device import resolve_device
from situation3d_tpu_torch.utils.trace import BATCH, span, spanned


class SceneCache:
    """scene_id -> (scene_tokens, scene_token_positions) on the device."""

    def __init__(self, model, device="cuda"):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model lives on {model.device}, cache asked for {self.device}")
        self.model = model
        self._cache: Dict[str, Any] = {}

    @torch.no_grad()
    def encode(self, scene_id: str, scene_batch: Dict[str, Any],
               sample_draws=None,
               generator: Optional[torch.Generator] = None) -> None:
        """Run the scene tower once; ``scene_batch`` holds one scene's voxel
        fields (batch axis 1). A scene already cached is left alone."""
        if scene_id in self._cache:
            return
        with span("serving.encode", request=BATCH):
            toks, pos, _ = self.model.encode_scene(scene_batch, sample_draws, generator)
        self._cache[scene_id] = (toks, pos)

    @torch.no_grad()
    @spanned("serving.answer", request=BATCH)
    def answer(self, scene_id: str, question_batch: Dict[str, Any]
               ) -> Dict[str, Any]:
        """Answer a batch of questions against one cached scene. The cached
        [1, N, C] tokens broadcast across the question batch."""
        toks, pos = self._cache[scene_id]
        B = question_batch["s_ids"].shape[0]
        batch = {k: v for k, v in question_batch.items()
                 if not k.startswith("voxel_")}
        batch["scene_tokens"] = toks.expand(B, *toks.shape[1:])
        batch["scene_token_positions"] = pos.expand(B, *pos.shape[1:])
        return self.model(batch)

    def __contains__(self, scene_id: str) -> bool:
        return scene_id in self._cache
