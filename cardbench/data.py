"""What the benchmark feeds both sides, made from ``--seed``: the
weights, drawn on the device in one call, and the batches, one seeded
draw a step on the device (``tokens`` and, where the configuration has a
conditioning memory, ``memory_embeds``). The same seed gives the same
weights and the same batch at every step, on the program's side and the
reference's."""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

#: tags that split one ``--seed`` into independent streams
WEIGHTS, DATA = 1, 2


def derive(seed: int, *tags: int) -> int:
    """A 63-bit seed of ``seed`` (any integer) and ``tags``."""
    entropy = [abs(int(seed)), int(seed < 0), *tags]
    return int(np.random.SeedSequence(entropy).generate_state(
        1, np.uint64)[0]) >> 1


# ------------------------------------------------------------------ trees
def flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` of a tree of dicts, lists and tuples; paths join
    keys and indices with ``/``."""
    if isinstance(tree, dict):
        items = list(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += flatten(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def rebuild(tree: Any, values: Dict[str, Any], prefix: str = "") -> Any:
    """``tree`` with each leaf replaced by ``values[path]``."""
    if isinstance(tree, dict):
        return {k: rebuild(v, values, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [rebuild(v, values, f"{prefix}/{i}" if prefix else str(i))
               for i, v in enumerate(tree)]
        return type(tree)(out)
    return values[prefix]


# ---------------------------------------------------------------- weights
def init_std(path: str, shape: Sequence[int]) -> Tuple[float, float]:
    """``(mean, std)`` of a leaf's normal draw: embedding and head 0.02,
    a norm's scale about 1 and its bias, like every projection bias,
    small; a matrix ``1 / sqrt(fan in)``, its second-last dimension."""
    name = path.rsplit("/", 1)[-1]
    if path.startswith("embed/"):
        return 0.0, 0.02
    if name == "scale":
        return 1.0, 0.1
    if name == "bias" or name.startswith("b"):
        return 0.0, 0.02
    return 0.0, 1.0 / math.sqrt(shape[-2])


def draw_weights(specs: Sequence[Tuple[str, Tuple[int, ...], torch.dtype]],
                 seed: int, device) -> Dict[str, torch.Tensor]:
    """One leaf a spec ``(path, shape, dtype)``: one normal draw of every
    element at once on ``device``, in order of path, scaled and cast."""
    specs = sorted(specs)
    total = sum(math.prod(s) for _p, s, _d in specs)
    gen = torch.Generator(device=device).manual_seed(derive(seed, WEIGHTS))
    z = torch.randn(total, generator=gen, device=device)
    out, pos = {}, 0
    for path, shape, dtype in specs:
        n = math.prod(shape)
        mean, std = init_std(path, shape)
        out[path] = z[pos:pos + n].mul(std).add_(mean).reshape(shape) \
            .to(dtype)
        pos += n
    return out


# ---------------------------------------------------------------- batches
class Batches:
    """The trainer's pipeline: ``next_batch_on(device)`` gives the batch
    of the current step and moves on; ``state`` is the cursor a
    checkpoint carries. ``on_fetch``, where set, is called with the
    number of batches fetched so far before each batch is drawn."""

    def __init__(self, cfg: Dict[str, Any], batch: int, seq_len: int,
                 seed: int):
        self.cfg, self.batch, self.seq_len, self.seed = cfg, batch, \
            seq_len, seed
        self.step = 0
        self.on_fetch = None

    @property
    def state(self) -> Dict[str, int]:
        return {"seed": self.seed, "step": self.step}

    def at(self, step: int, device) -> Dict[str, torch.Tensor]:
        """The batch of ``step`` (0 for the first)."""
        cfg = self.cfg
        gen = torch.Generator(device=device).manual_seed(
            derive(self.seed, DATA, step))
        shape: Tuple[int, ...] = (self.batch, self.seq_len)
        if cfg.get("n_codebooks"):
            shape += (cfg["n_codebooks"],)
        out = {"tokens": torch.randint(0, cfg["vocab"], shape, generator=gen,
                                       device=device, dtype=torch.int32)}
        if cfg.get("n_memory_embeds"):
            out["memory_embeds"] = torch.randn(
                (self.batch, cfg["n_memory_embeds"], cfg["d_model"]),
                generator=gen, device=device)
        return out

    def next_batch_on(self, device) -> Dict[str, torch.Tensor]:
        if self.on_fetch is not None:
            self.on_fetch(self.step)
        b = self.at(self.step, device)
        self.step += 1
        return b
