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
        """``{"tokens": int32 (batch, seq_len)}`` for the current step,
        then advance the cursor."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self._state.seed, self._state.step]))
        self._state.step += 1
        return {"tokens": rng.integers(0, self.cfg.vocab,
                                       size=(self.batch, self.seq_len),
                                       dtype=np.int32)}

    def next_batch_on(self, device: torch.device) -> Dict[str, torch.Tensor]:
        """:meth:`next_batch` as tensors on ``device``."""
        return {k: torch.from_numpy(v).to(device)
                for k, v in self.next_batch().items()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()
