"""Dream-and-Ponder agent (counterpart of sheeprl_tpu/algos/dream_and_ponder/agent.py):
the DreamerV3 world model and critic of the port with the actor replaced by a
:class:`~sheeprl_tpu_torch.algos.dream_and_ponder.ponder_actor.PonderActor`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from sheeprl_tpu_torch.algos.dream_and_ponder.ponder_actor import PonderActor
from sheeprl_tpu_torch.algos.dreamer_v3.agent import ActorOutput, PlayerDV3, _ln_enabled, hafner_init_
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent as dv3_build_agent

#: the name ``algo.actor.cls`` gives the ponder actor
Actor = PonderActor


class PlayerDAP(PlayerDV3):
    """The DV3 player whose actor step runs the ponder actor's masked halting
    forward; the posterior is sampled as the DV3 player samples it."""

    def _actor_step(self, latent: torch.Tensor, generator: torch.Generator, greedy: bool,
                    mask: Optional[Dict[str, torch.Tensor]]) -> List[torch.Tensor]:
        del mask  # the ponder actor has no masked (MineDojo) variant
        pre_dist, _ = self.actor.ponder_infer(latent, generator)
        return ActorOutput(self.actor, pre_dist).sample_actions_with_raw(generator, greedy)[0]


def build_agent(runtime, actions_dim: Sequence[int], is_continuous: bool, cfg, obs_space):
    """Modules on the run's device: ``(world_model, actor, critic,
    target_critic, player)``, the world model and critics those of DreamerV3,
    the ponder actor initialised from ``seed + 2`` (Hafner init: truncated
    normal trunks, fan-average uniform heads, zero biases, ``no_goal_yet``
    uniform in ``[0, 1)``)."""
    world_model, _, critic, target_critic, _ = dv3_build_agent(runtime, actions_dim, is_continuous, cfg, obs_space,
                                                               build_actor=False)
    wm_cfg, actor_cfg, ponder_cfg = cfg.algo.world_model, cfg.algo.actor, cfg.algo.ponder
    latent_size = (int(wm_cfg.stochastic_size) * int(wm_cfg.discrete_size)
                   + int(wm_cfg.recurrent_model.recurrent_state_size))
    actor_ln, actor_eps = _ln_enabled(actor_cfg.get("layer_norm"))
    actor = PonderActor(
        latent_size, actions_dim, is_continuous, cfg.distribution.get("type", "auto"), float(actor_cfg.init_std),
        float(actor_cfg.min_std), float(actor_cfg.get("max_std", 1.0)), int(actor_cfg.dense_units),
        int(actor_cfg.mlp_layers), actor_ln, actor_eps, actor_cfg.dense_act, float(cfg.algo.unimix),
        float(actor_cfg.get("action_clip", 1.0)), int(ponder_cfg.max_ponder_steps),
        float(ponder_cfg.cum_halt_prob_threshold), bool(ponder_cfg.get("deterministic_inference", False)),
    )
    gen = torch.Generator().manual_seed(int(cfg.seed) + 2)
    hafner_init_(actor, gen, {h: 1.0 for h in actor.heads})
    with torch.no_grad():
        actor.no_goal_yet.uniform_(0.0, 1.0, generator=gen)
    actor = actor.to(runtime.device)
    player = PlayerDAP(world_model, actor, actions_dim, int(cfg.env.num_envs), runtime)
    return world_model, actor, critic, target_critic, player
