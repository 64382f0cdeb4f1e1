"""Optimizers of the port (counterpart of sheeprl_tpu/utils/optim.py: adam and
the global-norm clipping of ``with_clipping``)."""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import torch


def adam(params: Iterable[torch.nn.Parameter], lr: float = 2e-4, eps: float = 1e-4, weight_decay: float = 0.0,
         betas: Sequence[float] = (0.9, 0.999)) -> torch.optim.Optimizer:
    """Adam as optax.adam computes it (eps outside the square root); with
    ``weight_decay > 0`` decoupled decay as optax.adamw."""
    if weight_decay and weight_decay > 0:
        return torch.optim.AdamW(params, lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay)
    return torch.optim.Adam(params, lr=lr, betas=tuple(betas), eps=eps)


class ClippedOptimizer:
    """Clip the gradients' global norm to ``max_grad_norm`` (as
    ``optax.clip_by_global_norm``: scale by ``max / norm`` when ``norm > max``),
    then step ``optimizer``."""

    def __init__(self, optimizer: torch.optim.Optimizer, max_grad_norm: Optional[float]):
        self.optimizer = optimizer
        self.max_grad_norm = float(max_grad_norm) if max_grad_norm else 0.0
        self.params = [p for group in optimizer.param_groups for p in group["params"]]

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        """Clip and step; returns the global norm before clipping."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        if self.max_grad_norm > 0:
            scale = torch.where(norm < self.max_grad_norm, torch.ones_like(norm), self.max_grad_norm / norm)
            for g in grads:
                g.mul_(scale)
        self.optimizer.step()
        return norm


def with_clipping(optimizer: torch.optim.Optimizer, max_grad_norm: Optional[float]) -> ClippedOptimizer:
    return ClippedOptimizer(optimizer, max_grad_norm)
