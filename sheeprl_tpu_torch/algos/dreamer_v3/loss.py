"""DreamerV3 world-model loss (counterpart of sheeprl_tpu/algos/dreamer_v3/loss.py)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def categorical_kl(p_logits: torch.Tensor, q_logits: torch.Tensor) -> torch.Tensor:
    """KL(p || q) of factorized categoricals ``[..., stoch, discrete]``, summed
    over stoch and discrete; computed in float32 whatever the logits' dtype."""
    p_log = torch.log_softmax(p_logits.float(), dim=-1)
    q_log = torch.log_softmax(q_logits.float(), dim=-1)
    return (p_log.exp() * (p_log - q_log)).sum(dim=(-2, -1))


def reconstruction_loss(
    po_log_probs: Dict[str, torch.Tensor],
    pr_log_prob: torch.Tensor,
    priors_logits: torch.Tensor,
    posteriors_logits: torch.Tensor,
    kl_dynamic: float = 0.5,
    kl_representation: float = 0.1,
    kl_free_nats: float = 1.0,
    kl_regularizer: float = 1.0,
    pc_log_prob: Optional[torch.Tensor] = None,
    continue_scale_factor: float = 1.0,
) -> Tuple[torch.Tensor, ...]:
    """(loss, kl, state_loss, reward_loss, observation_loss, continue_loss), all
    per-element ``[T, B]`` terms averaged once at the end."""
    observation_loss = -sum(po_log_probs.values())
    reward_loss = -pr_log_prob
    kl = categorical_kl(posteriors_logits.detach(), priors_logits)
    dyn_loss = kl_dynamic * kl.clamp_min(kl_free_nats)
    repr_loss = kl_representation * categorical_kl(posteriors_logits, priors_logits.detach()).clamp_min(kl_free_nats)
    kl_loss = dyn_loss + repr_loss
    continue_loss = continue_scale_factor * -pc_log_prob if pc_log_prob is not None else torch.zeros_like(reward_loss)
    loss = (kl_regularizer * kl_loss + observation_loss + reward_loss + continue_loss).mean()
    return loss, kl.mean(), kl_loss.mean(), reward_loss.mean(), observation_loss.mean(), continue_loss.mean()
