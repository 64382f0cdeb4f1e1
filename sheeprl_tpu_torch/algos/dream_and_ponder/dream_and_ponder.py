"""Dream-and-Ponder training of the port (counterpart of
sheeprl_tpu/algos/dream_and_ponder/dream_and_ponder.py: ``make_train_fn`` and
``main``): DreamerV3 with a PonderNet actor.

The target-critic EMA and the world model are DreamerV3's
(:class:`~sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3.DV3Trainer`). The
behaviour differs, as in the JAX train step:

- the first imagined actions come from the actor's train-mode pass, one per
  ponder step, beside the differentiable halting distribution;
- the N ponder branches are folded into the batch, branch-major (row
  ``n * TB + i`` is branch ``n`` of start ``i``), so the H imagination steps run
  once at ``N * T * B`` rows (the imagination kernel at ``B = 3 * 16 * 64`` in
  DAP-S), every step's action from the halting-mode actor;
- the log-probabilities at ``t = 0`` use each branch's own train-mode
  distribution, the later ones the halting-mode distributions its actions were
  drawn from (no second actor pass);
- one Moments update over ``[H, N * TB]``; the actor loss is the PonderNet
  loss of the per-branch policy losses with ``algo.ponder.beta``; the critic's
  per-branch two-hot losses are weighted by the detached halting distribution.

The host loop, checkpoints and resume are DreamerV3's (:func:`train`), with
the JAX Dream-and-Ponder checkpoint layout (the same keys; ``opt_states`` holds
the fields of ``DAPOptStates``).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from sheeprl_tpu_torch.algos.dream_and_ponder.agent import build_agent
from sheeprl_tpu_torch.algos.dream_and_ponder.ponder_actor import geometric_prior, ponder_loss
from sheeprl_tpu_torch.algos.dreamer_v3.agent import ActorOutput
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3Trainer, train
from sheeprl_tpu_torch.compat import flax_params
from sheeprl_tpu_torch.ops.distributions import gumbel
from sheeprl_tpu_torch.utils.registry import register_algorithm

METRIC_NAMES = (
    "Loss/world_model_loss", "Loss/value_loss", "Loss/policy_loss", "Loss/observation_loss", "Loss/reward_loss",
    "Loss/state_loss", "Loss/continue_loss", "State/kl", "State/post_entropy", "State/prior_entropy",
    "Grads/world_model", "Grads/actor", "Grads/critic", "State/expected_ponder_steps",
)


class DAPTrainer(DV3Trainer):
    """:class:`DV3Trainer` with the ponder-branched behaviour and critic."""

    metric_names = METRIC_NAMES

    def __init__(self, world_model, actor, critic, target_critic, cfg, runtime, is_continuous, actions_dim):
        super().__init__(world_model, actor, critic, target_critic, cfg, runtime, is_continuous, actions_dim)
        ponder = cfg.algo.ponder
        self.n_ponder = int(ponder.max_ponder_steps)
        self.ponder_beta = float(ponder.get("beta", 0.01))
        self.ponder_prior = torch.from_numpy(
            geometric_prior(self.n_ponder, float(ponder.lambda_prior_geom))).to(runtime.device)
        self.actor_roots = flax_params.ponder_actor_roots(actor.mlp_layers)

    def _branch_major(self, x: torch.Tensor) -> torch.Tensor:
        """``[TB, N, d]`` -> ``[N * TB, d]``, so ``reshape(N, TB)`` splits the branches."""
        return x.movedim(-2, 0).reshape(-1, x.shape[-1])

    def _per_branch(self, x: torch.Tensor) -> torch.Tensor:
        """Branch-major ``[N * TB]`` -> ``[TB, N]``."""
        return x.reshape(self.n_ponder, -1).T

    def behaviour_step(self, aux: Dict[str, Any], gen: torch.Generator):
        actor, rssm, dev, n = self.actor, self.world_model.rssm, self.runtime.device, self.n_ponder
        start_prior, start_rec, true_continue, fused_args = self.imagination_start(aux)
        with self.runtime.autocast():
            latent0 = torch.cat([start_prior.to(start_rec.dtype), start_rec], dim=-1)
            pre0, _, halt_dist = actor.ponder_train(latent0.detach())  # each [TB, N, dim]; [TB, N]
            acts0, raws0 = ActorOutput(actor, pre0).sample_actions_with_raw(gen)
            act = self._branch_major(torch.cat(acts0, dim=-1))
            prior, rec = start_prior.repeat(n, 1), start_rec.repeat(n, 1)
            latents = [torch.cat([prior.to(rec.dtype), rec], dim=-1)]
            raws = [self._branch_major(torch.cat(raws0, dim=-1))]
            pres = [[self._branch_major(p) for p in pre0]]
            for _ in range(self.horizon):
                g = gumbel((prior.shape[0], rssm.stochastic_size, rssm.discrete_size), gen, dev)
                prior, rec = rssm.imagination_step(prior, rec, act, g, fused_args)
                latent = torch.cat([prior.to(rec.dtype), rec], dim=-1)
                pre, _ = actor.ponder_infer(latent.detach(), gen)
                acts, step_raws = ActorOutput(actor, pre).sample_actions_with_raw(gen)
                act = torch.cat(acts, dim=-1)
                latents.append(latent)
                raws.append(torch.cat(step_raws, dim=-1))
                pres.append(pre)
            trajectories = torch.stack(latents)  # [H+1, N*TB, L]
            full_pre = [torch.stack(per_head) for per_head in zip(*pres)]  # each [H+1, N*TB, dim]
            predicted_values, lambda_values, discount = self.returns(trajectories, true_continue.repeat(n, 1))
            offset, invscale = self.moments.update(lambda_values)
            advantage = (lambda_values - offset) / invscale - (predicted_values[:-1] - offset) / invscale
            per_timestep = self.policy_terms(ActorOutput(actor, full_pre), torch.stack(raws), advantage, discount)
            per_sample = self._per_branch(per_timestep.mean(dim=0)[..., 0])
            policy_loss = ponder_loss(per_sample, halt_dist, self.ponder_prior, beta=self.ponder_beta)
        behaviour = dict(trajectories=trajectories.detach(), lambda_values=lambda_values.detach(), discount=discount,
                         halt_dist=halt_dist.detach())
        return policy_loss, self.actor_update(policy_loss), behaviour

    def critic_step(self, behaviour: Dict[str, Any]):
        per_sample = self._per_branch(self.critic_losses(behaviour).mean(dim=0))
        value_loss = (per_sample * behaviour["halt_dist"]).sum(dim=-1).mean()
        self.critic_opt.zero_grad()
        value_loss.backward()
        return value_loss, self.critic_opt.step()

    def extra_metrics(self, behaviour: Dict[str, Any]):
        """The expected ponder depth under the halting distribution."""
        steps = torch.arange(1, self.n_ponder + 1, dtype=torch.float32, device=self.runtime.device)
        return ((behaviour["halt_dist"] * steps).sum(dim=-1).mean(),)


@register_algorithm()
def main(runtime, cfg) -> Dict[str, Any]:
    """Train Dream-and-Ponder; returns the DreamerV3 host loop's summary."""
    return train(runtime, cfg, build_agent, DAPTrainer)
