"""PonderNet actor of Dream-and-Ponder (counterpart of
sheeprl_tpu/algos/dream_and_ponder/ponder_actor.py).

The actor refines an abstract "goal" from the latent state until a learned
halting unit decides the goal is ready to be decoded into action logits
(PonderNet, Banino et al. 2021).

- :meth:`PonderActor.ponder_train` runs all ``max_ponder_steps`` refinements
  and returns every step's decoded logits with the halting distribution.
- :meth:`PonderActor.ponder_infer` is a fixed-length masked loop: every
  instance runs all N steps and ``torch.where`` freezes the ones that have
  halted, as the JAX module does, so the loop's shape never depends on the
  data. The halting draw of step ``n`` is ``u_n < p_n`` with one uniform field
  per step (the JAX ``bernoulli(fold_in(key, n), p)`` is the same comparison).
- The halting distribution puts the leftover mass on the last step and the
  geometric prior its tail mass there too, so both sum to 1 over the
  truncated support.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from sheeprl_tpu_torch.models.models import MLP

PRE_SIGMOID_CLAMP = (-7.0, 7.0)


def uniform(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Float32 uniform noise in ``[0, 1)``, the field of one halting draw."""
    return torch.rand(shape, generator=generator, device=device, dtype=torch.float32)


def compute_halting_distribution(halt_probs: torch.Tensor) -> torch.Tensor:
    """Halting probabilities ``λ_n [..., N]`` -> ``p_n = λ_n Π_{i<n} (1 - λ_i)``,
    the leftover mass on the last step."""
    not_halt = (1.0 - halt_probs).clamp_min(1e-7)
    cumprods = torch.cat([torch.ones_like(not_halt[..., :1]), torch.cumprod(not_halt[..., :-1], dim=-1)], dim=-1)
    p_n = halt_probs * cumprods
    last = (1.0 - p_n[..., :-1].sum(dim=-1, keepdim=True)).clamp_min(0.0)
    return torch.cat([p_n[..., :-1], last], dim=-1)


def geometric_prior(max_ponder_steps: int, lambda_prior_geom: float) -> np.ndarray:
    """Truncated geometric prior with its tail mass on the last step:
    ``λ(1-λ)^(n-1)`` for ``n < N``, ``(1-λ)^(N-1)`` for ``n = N``."""
    if not 0.01 <= lambda_prior_geom < 1:
        raise ValueError("lambda_prior_geom must be in [0.01, 1)")
    n = max_ponder_steps
    if n == 1:
        return np.ones((1,), dtype=np.float32)
    base = 1.0 - float(lambda_prior_geom)
    head = float(lambda_prior_geom) * base ** np.arange(n - 1, dtype=np.float32)
    return np.concatenate([head, [base ** (n - 1)]]).astype(np.float32)


def ponder_loss(halt_step_task_losses: torch.Tensor, halt_distribution: torch.Tensor, prior: torch.Tensor,
                beta: float = 0.01) -> torch.Tensor:
    """PonderNet loss ``E_p[L_task] + β KL(p || p_G)`` over ``[B, N]`` losses
    and halting distribution and the ``[N]`` prior."""
    expected = (halt_step_task_losses * halt_distribution).sum(dim=-1).mean()
    eps = 1e-8
    kl = torch.log((halt_distribution + eps) / (prior + eps))
    return expected + beta * (halt_distribution * kl).sum(dim=-1).mean()


class PonderActor(nn.Module):
    """DreamerV3-style actor with a PonderNet core. Carries the distribution
    fields of the DV3 :class:`~sheeprl_tpu_torch.algos.dreamer_v3.agent.Actor`,
    so :class:`~sheeprl_tpu_torch.algos.dreamer_v3.agent.ActorOutput` wraps its
    logits unchanged. Hidden depths: the goal module ``ceil(0.8 L)``, the halt
    module and the action decoder ``ceil(0.4 L)`` for ``L = mlp_layers``."""

    #: the player hands no ``mask*`` observations to this actor
    uses_action_mask = False

    def __init__(self, latent_state_size: int, actions_dim: Sequence[int], is_continuous: bool,
                 distribution: str = "auto", init_std: float = 2.0, min_std: float = 0.1, max_std: float = 1.0,
                 dense_units: int = 1024, mlp_layers: int = 5, layer_norm: bool = True, eps: float = 1e-3,
                 activation: str = "silu", unimix: float = 0.01, action_clip: float = 1.0,
                 max_ponder_steps: int = 4, cum_halt_prob_threshold: float = 0.9,
                 deterministic_inference: bool = False):
        super().__init__()
        if not 0 < cum_halt_prob_threshold <= 1:
            raise ValueError("cum_halt_prob_threshold must be in (0, 1]")
        if max_ponder_steps <= 0:
            raise ValueError("max_ponder_steps must be positive")
        self.actions_dim = tuple(int(a) for a in actions_dim)
        self.is_continuous = is_continuous
        dist = str(distribution).lower()
        if dist not in ("auto", "normal", "tanh_normal", "discrete", "scaled_normal"):
            raise ValueError(f"The distribution must be on of: auto, discrete, normal, tanh_normal, scaled_normal. Found: {dist}")
        if dist == "discrete" and is_continuous:
            raise ValueError("You have choose a discrete distribution but `is_continuous` is true")
        self.distribution = ("scaled_normal" if is_continuous else "discrete") if dist == "auto" else dist
        self.init_std, self.min_std, self.max_std = init_std, min_std, max_std
        self.unimix, self.action_clip = unimix, action_clip
        self.mlp_layers = int(mlp_layers)
        self.max_ponder_steps = int(max_ponder_steps)
        self.cum_halt_prob_threshold = float(cum_halt_prob_threshold)
        self.deterministic_inference = bool(deterministic_inference)
        L = int(latent_state_size)

        def mlp(in_dim, out_dim, share):
            return MLP(in_dim, out_dim, [dense_units] * math.ceil(mlp_layers * share), activation, layer_norm,
                       {"eps": eps}, use_bias=not layer_norm)

        self.goal_ponder_module = mlp(2 * L, L, 0.8)  # [state, goal] -> refined goal
        self.halt_module = mlp(2 * L, 1, 0.4)  # [state, refined goal] -> halting logit
        self.action_decoder = mlp(L, None, 0.4)  # goal -> features of the heads
        outs = [2 * sum(self.actions_dim)] if is_continuous else list(self.actions_dim)
        self.heads = nn.ModuleList(nn.Linear(dense_units, o) for o in outs)
        self.no_goal_yet = nn.Parameter(torch.rand(L))

    def _ponder_step(self, state: torch.Tensor, goal: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One refinement: the new goal and its halting probability."""
        new_goal = self.goal_ponder_module(torch.cat([state, goal], dim=-1))
        logit = self.halt_module(torch.cat([state, new_goal], dim=-1)).clamp(*PRE_SIGMOID_CLAMP)
        return new_goal, torch.sigmoid(logit)[..., 0]

    def _decode(self, goal: torch.Tensor) -> List[torch.Tensor]:
        feats = self.action_decoder(goal)
        return [head(feats) for head in self.heads]

    def forward(self, state: torch.Tensor):
        return self.ponder_train(state)

    def ponder_train(self, state: torch.Tensor):
        """All N refinements of ``state [..., L]``: ``(pre_dist, halt_probs
        [..., N], halt_distribution [..., N])``, each logit tensor ``[..., N, dim]``."""
        goal = self.no_goal_yet.expand(state.shape).to(state.dtype)
        goals, halt_probs = [], []
        for _ in range(self.max_ponder_steps):
            goal, halt_prob = self._ponder_step(state, goal)
            goals.append(goal)
            halt_probs.append(halt_prob)
        halt_probs_st = torch.stack(halt_probs, dim=-1)
        return self._decode(torch.stack(goals, dim=-2)), halt_probs_st, compute_halting_distribution(halt_probs_st)

    def ponder_infer(self, state: torch.Tensor, generator: Optional[torch.Generator] = None):
        """Masked halting forward of ``state [..., L]``: ``(pre_dist,
        halted_step)``, logits ``[..., dim]`` decoded from the goal each
        instance halted at, ``halted_step`` in ``1..N``. A step halts an
        instance on its draw (``p > 0.5`` under ``deterministic_inference``)
        or when the λ it has accumulated while active reaches
        ``cum_halt_prob_threshold``; an instance that never halts takes the
        last goal."""
        batch_shape = state.shape[:-1]
        goal = self.no_goal_yet.expand(state.shape).to(state.dtype)
        has_halted = torch.zeros(batch_shape, dtype=torch.bool, device=state.device)
        halted_goal = torch.zeros_like(state)
        halted_step = torch.zeros(batch_shape, dtype=torch.int32, device=state.device)
        cum_halt_prob = torch.zeros(batch_shape, dtype=torch.float32, device=state.device)
        for step in range(self.max_ponder_steps):
            goal, halt_prob = self._ponder_step(state, goal)
            halt_prob = halt_prob.float()
            if self.deterministic_inference:
                decision = halt_prob > 0.5
            else:
                decision = uniform(batch_shape, generator, state.device) < halt_prob
            new_halts = decision & ~has_halted
            halted_goal = torch.where(new_halts[..., None], goal, halted_goal)
            halted_step = torch.where(new_halts, step + 1, halted_step)
            has_halted = has_halted | decision
            # λ accumulates for the still-active instances; past the threshold they halt here
            cum_halt_prob = cum_halt_prob + halt_prob * (~has_halted)
            threshold_halts = (cum_halt_prob >= self.cum_halt_prob_threshold) & ~has_halted
            halted_goal = torch.where(threshold_halts[..., None], goal, halted_goal)
            halted_step = torch.where(threshold_halts, step + 1, halted_step)
            has_halted = has_halted | threshold_halts
        halted_goal = torch.where(has_halted[..., None], halted_goal, goal)
        halted_step = torch.where(has_halted, halted_step, self.max_ponder_steps)
        return self._decode(halted_goal), halted_step
