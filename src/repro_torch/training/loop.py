"""Two-phase training loop with lazy checkpoint integration (port of
``repro/training/loop.py``, paper Fig 6).

Each step runs forward and backward (:func:`make_grad_step`, the
*immutable window*: params and optimizer state are only read), then the
update (:func:`make_update_step`). The update is AdamW in place under
``torch.no_grad()`` (:mod:`repro_torch.optim.adamw`): it
overwrites the very buffers a save requested at the previous iteration's
end may still be copying to the host, so
:meth:`CheckpointManager.wait_for_capture` sits between backward and
update, as the JAX package's donating update needs it. Every leaf of a
batch goes to the device (the tokens, with codebooks ``(B, S, K)``, the
prefix-LM's fp32 ``prefix_embeds`` and the conditioning memory's fp32
``memory_embeds``); the loss carries the MoE aux term
(``models.model.loss_fn``); past 2,048 tokens the
attention trains through :class:`repro_torch.models.layers._Flash`, the
kernel's forward with the reference's blocked backward.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core import CheckpointManager, resolve_device
from repro_torch.core.tree import flatten_with_path, map_leaves
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.models import model as M
from repro_torch.obs import trace as obs
from repro_torch.optim.adamw import AdamWConfig, apply_updates, init_opt_state


@dataclasses.dataclass
class IterationRecord:
    step: int
    loss: float
    iter_s: float
    ckpt_stall_s: float       # direct stall (capture barrier + save prologue)
    ckpt_requested: bool
    # the port's split of the step: forward + backward (on a card, CUDA
    # event time on the step's stream, read after the loss, so it adds no
    # synchronisation) and the save prologue inside ``ckpt_stall_s``
    grad_s: float = 0.0
    prologue_s: float = 0.0


def _trainable(params: Any) -> Any:
    return map_leaves(lambda t: t.detach().requires_grad_(True), params)


def _loss_and_grads(cfg, params: Any, batch: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Any]:
    """The loss (detached) and the gradients of every leaf of ``params``
    (which require grad), in the params' tree."""
    flat, unflatten = flatten_with_path(params)
    loss = M.loss_fn(cfg, params, batch)
    grads = torch.autograd.grad(loss, [t for _p, t in flat])
    return loss.detach(), unflatten(list(grads))


def make_grad_step(cfg) -> Callable:
    """The immutable window (the reference's ``make_grad_step``):
    ``grad_step(params, batch) -> (grads, loss)``, forward and backward;
    params are only read. The loss is detached."""
    def grad_step(params, batch):
        loss, grads = _loss_and_grads(cfg, params, batch)
        return grads, loss
    return grad_step


def make_update_step(cfg, hp: AdamWConfig) -> Callable:
    """The mutation point (the reference's ``make_update_step``):
    ``update_step(params, opt_state, grads) -> (params, opt_state)``, the
    AdamW update in place, so what comes back are the very tensors passed
    in. It is the counterpart of the reference's donation of ``params``
    and ``opt_state``, and it is what makes the capture barrier
    necessary: a save still copying those buffers must be waited for
    first (:meth:`CheckpointManager.wait_for_capture`)."""
    def update_step(params, opt_state, grads):
        apply_updates(params, opt_state, grads, hp)
        return params, opt_state
    return update_step


def make_train_step(cfg, hp: AdamWConfig) -> Callable:
    """The fused step the dry run traces (the reference's
    ``make_train_step``): :func:`make_grad_step`'s half, then
    :func:`make_update_step`'s; returns ``(params, opt_state, loss)``, the
    first two the very tensors passed in, updated. :class:`Trainer` runs
    the two halves with the capture barrier between them."""
    grad_step = make_grad_step(cfg)
    update_step = make_update_step(cfg, hp)

    def train_step(params, opt_state, batch):
        grads, loss = grad_step(params, batch)
        update_step(params, opt_state, grads)
        return params, opt_state, loss
    return train_step


class Trainer:
    """End-to-end driver: data → two-phase step → lazy checkpoints.

    ``device`` defaults to ``"cuda"`` and raises on a host without a card;
    params are drawn from a ``torch.Generator`` seeded with ``seed`` on
    that device (other numbers than JAX's for the same seed)."""

    def __init__(self, cfg, *, batch: int, seq_len: int,
                 hp: Optional[AdamWConfig] = None,
                 manager: Optional[CheckpointManager] = None,
                 seed: int = 0, device: torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.hp = hp or AdamWConfig()
        self.manager = manager
        self.pipeline = SyntheticTokenPipeline(cfg, batch, seq_len, seed=seed)
        self.grad_step = make_grad_step(cfg)
        self.update_step = make_update_step(cfg, self.hp)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = _trainable(M.init_params(cfg, gen, self.device))
        self.opt_state = init_opt_state(self.params)
        self.step = 0
        self.records: List[IterationRecord] = []
        self.last_resume_stats = None  # RestoreStats from the last resume()
        self.exit_drain_s = 0.0        # end-of-run persist/commit wait

    # -- checkpoint state composition (the paper's heterogeneous pytree) ----
    def state(self) -> Dict[str, Any]:
        return {
            "model": self.params,
            "optimizer": self.opt_state,
            "meta": {
                "step": self.step,
                "arch": self.cfg.name,
                "data_state": self.pipeline.state,
                "hp": self.hp._asdict(),
                "rng": {"seed": 0},
            },
        }

    def resume(self, step: Optional[int] = None,
               fallback: Optional[bool] = None,
               domains: Optional[Tuple[str, ...]] = None) -> int:
        """Resume from a committed checkpoint through the manager's
        restore engine (a delta step replays its chain; quantized
        optimizer state is decoded on the manager's device). Params come
        back trainable. ``domains`` forwards to the selective restore:
        ``resume(domains=("model",))`` reloads parameters only."""
        if self.manager is None:
            raise ValueError("resume() needs a CheckpointManager")
        restored = self.manager.restore(self.state(), step=step,
                                        fallback=fallback, domains=domains)
        self.params = _trainable(restored["model"])
        self.opt_state = restored["optimizer"]
        self.step = restored["meta"]["step"]
        self.pipeline.restore(restored["meta"]["data_state"])
        self.last_resume_stats = self.manager.last_restore_stats
        return self.step

    def run(self, n_steps: int,
            ckpt_interval: int = 0) -> List[IterationRecord]:
        ckpt_pending = False
        on_card = self.device.type == "cuda"
        for _ in range(n_steps):
            t0 = time.perf_counter()
            batch = self.pipeline.next_batch_on(self.device)
            # --- immutable window: forward + backward ---------------------
            if on_card:
                ev0 = torch.cuda.Event(enable_timing=True)
                ev1 = torch.cuda.Event(enable_timing=True)
                ev0.record()
            t_g = time.perf_counter()
            grads, loss = self.grad_step(self.params, batch)
            if on_card:
                ev1.record()
            else:
                grad_s = time.perf_counter() - t_g
            # --- capture barrier before the in-place update ---------------
            stall = 0.0
            if ckpt_pending:
                t_b = time.perf_counter()
                stall = self.manager.wait_for_capture()
                obs.add_span("ckpt.capture_barrier", t_b, t_b + stall,
                             step=self.step)
                ckpt_pending = False
            self.update_step(self.params, self.opt_state, grads)
            del grads
            self.step += 1
            # --- checkpoint request (lazy: overlaps next fwd/bwd) ---------
            requested = False
            prologue = 0.0
            if ckpt_interval and self.manager is not None \
                    and self.step % ckpt_interval == 0:
                t_save = time.perf_counter()
                self.manager.save(self.step, self.state())
                prologue = time.perf_counter() - t_save
                stall += prologue  # blocking prologue
                ckpt_pending = True
                requested = True
            loss_val = float(loss)
            if on_card:
                grad_s = ev0.elapsed_time(ev1) / 1e3
            t1 = time.perf_counter()
            self.records.append(IterationRecord(
                step=self.step, loss=loss_val, iter_s=t1 - t0,
                ckpt_stall_s=stall, ckpt_requested=requested,
                grad_s=grad_s, prologue_s=prologue))
            obs.add_span("train.iteration", t0, t1, step=self.step,
                         stall_s=stall)
        self.exit_drain_s = 0.0
        if self.manager is not None:
            # End-of-run drain is blocking time too: folded into the last
            # record's stall, so a save requested on the last iterations
            # does not look free.
            t_d = time.perf_counter()
            self.manager.wait_for_persist()
            self.manager.wait_for_commit()
            self.exit_drain_s = time.perf_counter() - t_d
            obs.add_span("ckpt.exit_drain", t_d, t_d + self.exit_drain_s)
            if self.records and self.exit_drain_s > 0:
                last = self.records[-1]
                self.records[-1] = dataclasses.replace(
                    last, ckpt_stall_s=last.ckpt_stall_s
                    + self.exit_drain_s)
        return self.records

