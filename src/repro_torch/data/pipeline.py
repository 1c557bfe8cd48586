"""Deterministic synthetic token pipeline (port of ``repro/data/pipeline.py``).

A seeded, restartable stream of token batches with the shapes the configs
request. The iterator state (seed + step) rides every checkpoint as a host
object, so a restored run resumes the stream exactly. Batches are drawn
with numpy from ``SeedSequence([seed, step])`` exactly as the JAX package
draws them, so both packages see identical tokens; :meth:`next_batch`
returns numpy arrays and :meth:`next_batch_on` tensors on a device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch


@dataclasses.dataclass
class DataState:
    seed: int
    step: int

    def as_dict(self) -> Dict[str, int]:
        return {"seed": self.seed, "step": self.step}


class SyntheticTokenPipeline:
    """Seeded batch stream; ``state``/``restore`` give exact resumability."""

    def __init__(self, cfg, batch: int, seq_len: int, seed: int = 0):
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self._state = DataState(seed=seed, step=0)

    # -- checkpointable state ------------------------------------------------
    @property
    def state(self) -> Dict[str, int]:
        return self._state.as_dict()

    def restore(self, state: Dict[str, int]) -> None:
        self._state = DataState(**state)

    # -- iteration -----------------------------------------------------------
    def next_batch(self) -> Dict[str, np.ndarray]:
        """``{"tokens": int32 (batch, seq_len[, n_codebooks])}``, with
        ``"prefix_embeds"`` fp32 ``(batch, n_prefix_embeds, d_model)``
        where the config is a prefix-LM and ``"memory_embeds"`` fp32
        ``(batch, n_memory_embeds, d_model)`` where it has a memory, for
        the current step; then advance the cursor. Drawn in the
        reference's order from one generator."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([self._state.seed, self._state.step]))
        self._state.step += 1
        shape = (self.batch, self.seq_len)
        if cfg.n_codebooks:
            shape = shape + (cfg.n_codebooks,)
        batch = {"tokens": rng.integers(0, cfg.vocab, size=shape,
                                        dtype=np.int32)}
        if cfg.n_prefix_embeds:
            batch["prefix_embeds"] = rng.standard_normal(
                (self.batch, cfg.n_prefix_embeds, cfg.d_model),
                dtype=np.float32)
        if cfg.n_memory_embeds:
            batch["memory_embeds"] = rng.standard_normal(
                (self.batch, cfg.n_memory_embeds, cfg.d_model),
                dtype=np.float32)
        return batch

    def next_batch_on(self, device: torch.device) -> Dict[str, torch.Tensor]:
        """:meth:`next_batch` as tensors on ``device``, every leaf."""
        return {k: torch.from_numpy(v).to(device)
                for k, v in self.next_batch().items()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()
