"""DreamerV3 training of the port (counterpart of
sheeprl_tpu/algos/dreamer_v3/dreamer_v3.py: the train step of
``make_train_fn``/``one_step`` and the host loop of ``main``).

One gradient step (:meth:`DV3Trainer.train_step`): the target-critic EMA, the
world-model update (:meth:`~DV3Trainer.world_model_step`: encoder over
``[T, B]``, the RSSM dynamic scan, decoder, reward and continue heads, the
KL-balanced loss), the actor update on an H-step imagination from every
posterior (:meth:`~DV3Trainer.behaviour_step`), and the two-hot critic update
(:meth:`~DV3Trainer.critic_step`). Dream-and-Ponder overrides the last two.
Metrics are printed to stdout. :func:`train` is the host loop of both
algorithms, given their ``build_agent`` and trainer class.

Checkpoints: every ``checkpoint.every`` policy steps and at the end
(``checkpoint.save_last``) the loop writes
``<log_dir>/checkpoint/ckpt_<policy_step>_0.ckpt`` in the JAX package's
container and layout (:meth:`DV3Trainer.state_dict`), with the replay buffer
when ``buffer.checkpoint`` is set; ``checkpoint.resume_from`` resumes from a
file of either package. The logger, metric-aggregator, health, pipeline,
profiler, telemetry, preemption and non-finite-guard planes of the JAX loop are
not ported yet.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Any, Callable, Dict, List, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_v3.agent import ActorOutput, build_agent
from sheeprl_tpu_torch.algos.dreamer_v3.loss import reconstruction_loss
from sheeprl_tpu_torch.algos.dreamer_v3.utils import Moments, compute_lambda_values, prepare_obs, test
from sheeprl_tpu_torch.compat import flax_params
from sheeprl_tpu_torch.config import ConfigError, instantiate
from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, SequentialReplayBuffer
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.ops.distributions import (
    BernoulliSafeMode,
    Independent,
    MSEDistribution,
    OneHotCategorical,
    SymlogDistribution,
    TwoHotEncodingDistribution,
    gumbel,
)
from sheeprl_tpu_torch.utils.checkpoint import CheckpointCallback, load_state
from sheeprl_tpu_torch.utils.env import make_env, vectorized_env
from sheeprl_tpu_torch.utils.optim import with_clipping
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.utils import Ratio, get_log_dir, polyak_update, save_configs

METRIC_NAMES = (
    "Loss/world_model_loss", "Loss/value_loss", "Loss/policy_loss", "Loss/observation_loss", "Loss/reward_loss",
    "Loss/state_loss", "Loss/continue_loss", "State/kl", "State/post_entropy", "State/prior_entropy",
    "Grads/world_model", "Grads/actor", "Grads/critic", "State/moments_low", "State/moments_high",
)


class DV3Trainer:
    """Optimizers, return moments and the gradient-step counter around the modules."""

    #: the names of :meth:`train_step`'s metrics, in order
    metric_names = METRIC_NAMES

    def __init__(self, world_model, actor, critic, target_critic, cfg, runtime, is_continuous: bool,
                 actions_dim: Sequence[int]):
        self.world_model, self.actor, self.critic, self.target_critic = world_model, actor, critic, target_critic
        self.runtime = runtime
        self.is_continuous = is_continuous
        self.actions_dim = list(actions_dim)
        algo = cfg.algo
        self.horizon, self.gamma, self.lmbda = int(algo.horizon), float(algo.gamma), float(algo.lmbda)
        self.ent_coef = float(algo.actor.ent_coef)
        self.kl = dict(kl_dynamic=float(algo.world_model.kl_dynamic),
                       kl_representation=float(algo.world_model.kl_representation),
                       kl_free_nats=float(algo.world_model.kl_free_nats),
                       kl_regularizer=float(algo.world_model.kl_regularizer),
                       continue_scale_factor=float(algo.world_model.continue_scale_factor))
        self.cnn_keys, self.mlp_keys = list(algo.cnn_keys.encoder), list(algo.mlp_keys.encoder)
        self.cnn_keys_dec, self.mlp_keys_dec = list(algo.cnn_keys.decoder), list(algo.mlp_keys.decoder)
        self.target_freq = int(algo.critic.per_rank_target_network_update_freq)
        self.tau = float(algo.critic.tau)
        self.objective = str(algo.actor.get("objective", "auto"))
        if self.objective not in ("auto", "reinforce"):
            raise ValueError(f"algo.actor.objective must be 'auto' or 'reinforce', got {self.objective!r}")
        m = algo.actor.moments
        self.moments = Moments(float(m.decay), float(m.max), float(m.percentile.low), float(m.percentile.high),
                               device=runtime.device)
        self.world_opt = with_clipping(instantiate(dict(algo.world_model.optimizer))(world_model.parameters()),
                                       algo.world_model.clip_gradients)
        self.actor_opt = with_clipping(instantiate(dict(algo.actor.optimizer))(actor.parameters()),
                                       algo.actor.clip_gradients)
        self.critic_opt = with_clipping(instantiate(dict(algo.critic.optimizer))(critic.parameters()),
                                        algo.critic.clip_gradients)
        self.counter = 0
        #: flax paths of the actor's parameters (the DV3 actor is one flax module)
        self.actor_roots = flax_params.MODULE_ROOTS

    def _nets(self):
        """``(checkpoint key, module, flax roots, optimizer key, optimizer)``."""
        return (("world_model", self.world_model, flax_params.WORLD_MODEL_ROOTS, "world", self.world_opt),
                ("actor", self.actor, self.actor_roots, "actor", self.actor_opt),
                ("critic", self.critic, flax_params.MODULE_ROOTS, "critic", self.critic_opt),
                ("target_critic", self.target_critic, flax_params.MODULE_ROOTS, None, None))

    def state_dict(self) -> Dict[str, Any]:
        """The trainer's part of a checkpoint in the JAX package's layout:
        flax trees of the four networks, the optax chain states of the three
        optimizers (as plain containers), ``moments`` and ``counter``."""
        out: Dict[str, Any] = {}
        opt_states: Dict[str, Any] = {}
        for key, module, roots, opt_key, opt in self._nets():
            named = dict(module.named_parameters())
            out[key] = flax_params.to_flax(named, roots)
            if opt is not None:
                opt_states[opt_key] = flax_params.adam_state_to_optax(opt.optimizer, named, roots, opt.max_grad_norm > 0)
        out["opt_states"] = opt_states
        out["moments"] = tuple(t.detach().float().cpu().numpy() for t in (self.moments.low, self.moments.high))
        out["counter"] = int(self.counter)
        return out

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Load :meth:`state_dict`'s keys from a checkpoint of either package.
        Everything is checked before anything is set: a state that does not
        fit raises, naming the first leaf that differs."""
        opt_states = state["opt_states"]
        if hasattr(opt_states, "_asdict"):
            opt_states = opt_states._asdict()
        appliers: List[Callable[[], None]] = []
        for key, module, roots, opt_key, opt in self._nets():
            appliers.append(flax_params.module_loader(module, state[key], roots, key))
            if opt is not None:
                appliers.append(flax_params.adam_loader(opt.optimizer, dict(module.named_parameters()),
                                                        opt_states[opt_key], roots, opt.max_grad_norm > 0,
                                                        f"opt_states.{opt_key}"))
        moments = [np.asarray(v) for v in state["moments"]]
        if len(moments) != 2 or any(m.shape != () or m.dtype != np.float32 for m in moments):
            raise ValueError("moments: the checkpoint holds "
                             f"{[(m.shape, str(m.dtype)) for m in moments]}, expected two float32 scalars (low, high)")
        for apply in appliers:
            apply()
        dev = self.runtime.device
        self.moments.low, self.moments.high = (torch.tensor(m, device=dev) for m in moments)
        self.counter = int(state["counter"])

    def world_loss(self, data: Dict[str, torch.Tensor], gumbel_field: torch.Tensor):
        """World-model loss on a ``[T, B]`` batch with the posterior Gumbel field;
        returns ``(loss, aux)``."""
        wm = self.world_model
        batch_obs = {k: data[k].float() / 255.0 - 0.5 for k in self.cnn_keys}
        batch_obs.update({k: data[k].float() for k in self.mlp_keys})
        is_first = data["is_first"].float().clone()
        is_first[0] = 1.0
        actions = data["actions"].float()
        batch_actions = torch.cat([torch.zeros_like(actions[:1]), actions[:-1]], dim=0)
        rewards = data["rewards"].float()
        continues_targets = 1.0 - data["terminated"].float()
        with self.runtime.autocast():
            embedded = wm.encoder(batch_obs)
            recurrent_states, posteriors, priors_logits, posteriors_logits = wm.rssm.dynamic_scan(
                embedded, batch_actions, is_first, gumbel_field)
            latent = torch.cat([posteriors.reshape(*posteriors.shape[:-2], -1), recurrent_states.to(posteriors.dtype)], -1)
            reconstructed = wm.observation_model(latent)
            po_log_probs = {k: MSEDistribution(reconstructed[k], dims=reconstructed[k].dim() - 2).log_prob(batch_obs[k])
                            for k in self.cnn_keys_dec}
            po_log_probs.update({k: SymlogDistribution(reconstructed[k], dims=reconstructed[k].dim() - 2).log_prob(
                batch_obs[k]) for k in self.mlp_keys_dec})
            pr = TwoHotEncodingDistribution(wm.reward_model(latent), dims=1)
            pc = Independent(BernoulliSafeMode(wm.continue_model(latent)), 1)
            loss, kl, state_loss, reward_loss, observation_loss, continue_loss = reconstruction_loss(
                po_log_probs, pr.log_prob(rewards), priors_logits, posteriors_logits,
                pc_log_prob=pc.log_prob(continues_targets), **self.kl)
        aux = dict(posteriors=posteriors, recurrent_states=recurrent_states, priors_logits=priors_logits,
                   posteriors_logits=posteriors_logits, kl=kl, state_loss=state_loss, reward_loss=reward_loss,
                   observation_loss=observation_loss, continue_loss=continue_loss,
                   continues_targets=continues_targets)
        return loss, aux

    def train_step(self, data: Dict[str, torch.Tensor], gen: torch.Generator) -> torch.Tensor:
        """One gradient step on a ``[T, B]`` batch: the target-critic EMA, then
        :meth:`world_model_step`, :meth:`behaviour_step` and :meth:`critic_step`;
        returns the metrics of :attr:`metric_names` as one tensor."""
        if self.counter % self.target_freq == 0:
            polyak_update(self.critic.parameters(), self.target_critic.parameters(),
                          1.0 if self.counter == 0 else self.tau)
        world_loss, world_grad_norm, aux = self.world_model_step(data, gen)
        policy_loss, actor_grad_norm, behaviour = self.behaviour_step(aux, gen)
        value_loss, critic_grad_norm = self.critic_step(behaviour)
        self.counter += 1
        with torch.no_grad():
            post_ent = Independent(OneHotCategorical(aux["posteriors_logits"].float()), 1).entropy().mean()
            prior_ent = Independent(OneHotCategorical(aux["priors_logits"].float()), 1).entropy().mean()
            return torch.stack([t.detach().float() for t in (
                world_loss, value_loss, policy_loss, aux["observation_loss"], aux["reward_loss"], aux["state_loss"],
                aux["continue_loss"], aux["kl"], post_ent, prior_ent, world_grad_norm, actor_grad_norm,
                critic_grad_norm, *self.extra_metrics(behaviour))])

    def world_model_step(self, data: Dict[str, torch.Tensor], gen: torch.Generator):
        """The world model's update on the batch: ``(loss, grad_norm, aux)``."""
        rssm = self.world_model.rssm
        T, B = data["is_first"].shape[:2]
        g_wm = gumbel((T, B, rssm.stochastic_size, rssm.discrete_size), gen, self.runtime.device)
        world_loss, aux = self.world_loss(data, g_wm)
        self.world_opt.zero_grad()
        world_loss.backward()
        return world_loss, self.world_opt.step(), aux

    def imagination_start(self, aux: Dict[str, Any]):
        """Every posterior of the batch as an imagination start, detached:
        ``(prior [TB, S*D], recurrent [TB, R], true continues [TB, 1], the
        fused step's arguments or None)``."""
        rssm = self.world_model.rssm
        T, B = aux["posteriors"].shape[:2]
        prior = aux["posteriors"].detach().reshape(T * B, rssm.stoch_state_size)
        rec = aux["recurrent_states"].detach().reshape(T * B, -1)
        fused_args = rssm.imagination_args(self.runtime.device, sum(self.actions_dim)) if rssm.kernels != "off" else None
        return prior, rec, aux["continues_targets"].reshape(-1, 1), fused_args

    def returns(self, trajectories: torch.Tensor, true_continue: torch.Tensor):
        """Critic values, TD(lambda) returns and discounts of imagined
        ``[H+1, M, L]`` trajectories of ``M`` rows, the first continue flag the
        data's: ``(values [H+1, M, 1], lambda_values [H, M, 1], discount [H+1, M, 1])``."""
        wm = self.world_model
        predicted_values = TwoHotEncodingDistribution(self.critic(trajectories), dims=1).mean
        predicted_rewards = TwoHotEncodingDistribution(wm.reward_model(trajectories), dims=1).mean
        continues = Independent(BernoulliSafeMode(wm.continue_model(trajectories)), 1).base.mode
        continues = torch.cat([true_continue[None], continues[1:]], dim=0)
        lambda_values = compute_lambda_values(predicted_rewards[1:], predicted_values[1:],
                                              continues[1:] * self.gamma, lmbda=self.lmbda)
        discount = (torch.cumprod(continues * self.gamma, dim=0) / self.gamma).detach()
        return predicted_values, lambda_values, discount

    def policy_terms(self, policies: ActorOutput, raw_actions: torch.Tensor, advantage: torch.Tensor,
                     discount: torch.Tensor) -> torch.Tensor:
        """The per-timestep policy loss ``[H, M, 1]``: the dynamics objective
        (continuous, unless ``objective=reinforce``) or the score function at
        the raw samples, plus the entropy bonus, discounted."""
        if self.is_continuous and self.objective != "reinforce":
            objective = advantage
        else:
            parts = torch.split(raw_actions.detach(), self.actions_dim, dim=-1)
            log_probs = sum(d.log_prob(a) for d, a in zip(policies.dists, parts))
            objective = log_probs[..., None][:-1] * advantage.detach()
        try:
            entropy = self.ent_coef * policies.entropy()
        except NotImplementedError:
            entropy = torch.zeros(raw_actions.shape[:-1], device=raw_actions.device)
        return -(discount[:-1] * (objective + entropy[..., None][:-1]))

    def actor_update(self, policy_loss: torch.Tensor) -> torch.Tensor:
        """Step the actor on ``policy_loss``; returns its gradient norm."""
        actor_params = list(self.actor.parameters())
        self.actor_opt.zero_grad()
        for p, g_p in zip(actor_params, torch.autograd.grad(policy_loss, actor_params, allow_unused=True)):
            p.grad = g_p
        return self.actor_opt.step()

    def behaviour_step(self, aux: Dict[str, Any], gen: torch.Generator):
        """The actor's update on an H-step imagination from every posterior,
        with the updated world model: ``(policy_loss, grad_norm, behaviour)``,
        ``behaviour`` holding what :meth:`critic_step` reads."""
        actor, rssm, dev = self.actor, self.world_model.rssm, self.runtime.device
        prior, rec, true_continue, fused_args = self.imagination_start(aux)
        with self.runtime.autocast():
            latent = torch.cat([prior.to(rec.dtype), rec], dim=-1)
            acts, raws = ActorOutput(actor, actor(latent.detach())).sample_actions_with_raw(gen)
            act = torch.cat(acts, dim=-1)
            latents, im_actions_raw = [latent], [torch.cat(raws, dim=-1)]
            for _ in range(self.horizon):
                g = gumbel((prior.shape[0], rssm.stochastic_size, rssm.discrete_size), gen, dev)
                prior, rec = rssm.imagination_step(prior, rec, act, g, fused_args)
                latent = torch.cat([prior.to(rec.dtype), rec], dim=-1)
                acts, raws = ActorOutput(actor, actor(latent.detach())).sample_actions_with_raw(gen)
                act = torch.cat(acts, dim=-1)
                latents.append(latent)
                im_actions_raw.append(torch.cat(raws, dim=-1))
            trajectories = torch.stack(latents)  # [H+1, TB, L]
            predicted_values, lambda_values, discount = self.returns(trajectories, true_continue)
            offset, invscale = self.moments.update(lambda_values)
            advantage = (lambda_values - offset) / invscale - (predicted_values[:-1] - offset) / invscale
            policies = ActorOutput(actor, actor(trajectories.detach()))
            policy_loss = self.policy_terms(policies, torch.stack(im_actions_raw), advantage, discount).mean()
        behaviour = dict(trajectories=trajectories.detach(), lambda_values=lambda_values.detach(), discount=discount)
        return policy_loss, self.actor_update(policy_loss), behaviour

    def critic_losses(self, behaviour: Dict[str, Any]) -> torch.Tensor:
        """The critic's two-hot losses ``[H, M]`` on the imagined trajectories
        (of the actor before its update), discounted."""
        traj = behaviour["trajectories"]
        with self.runtime.autocast():
            qv = TwoHotEncodingDistribution(self.critic(traj[:-1]), dims=1)
            with torch.no_grad():
                target_values = TwoHotEncodingDistribution(self.target_critic(traj[:-1]), dims=1).mean
            value_loss = -qv.log_prob(behaviour["lambda_values"]) - qv.log_prob(target_values)
            return value_loss * behaviour["discount"][:-1][..., 0]

    def critic_step(self, behaviour: Dict[str, Any]):
        """The critic's update: ``(value_loss, grad_norm)``."""
        value_loss = self.critic_losses(behaviour).mean()
        self.critic_opt.zero_grad()
        value_loss.backward()
        return value_loss, self.critic_opt.step()

    def extra_metrics(self, behaviour: Dict[str, Any]):
        """The metrics after the thirteen every Dreamer step reports."""
        return self.moments.low, self.moments.high


def _actions_dim(action_space) -> List[int]:
    if isinstance(action_space, spaces.Box):
        return list(action_space.shape)
    if isinstance(action_space, spaces.MultiDiscrete):
        return action_space.nvec.tolist()
    return [action_space.n]


@register_algorithm()
def main(runtime, cfg) -> Dict[str, Any]:
    """Train DreamerV3; returns :func:`train`'s summary."""
    return train(runtime, cfg, build_agent, DV3Trainer)


def train(runtime, cfg, build_agent_fn: Callable, trainer_cls: type) -> Dict[str, Any]:
    """The host loop of a Dreamer algorithm, with its ``build_agent`` and
    trainer class; returns a summary: gradient steps, per-train-call losses,
    the seconds per gradient step after the first train call, the run's log
    dir, and under ``live`` the trainer, replay buffer, generator and ratio as
    the run left them."""
    if cfg.checkpoint.get("sharded"):
        raise ConfigError("checkpoint.sharded=True: sharded checkpoints are not ported; the port writes one file")
    if int(cfg.checkpoint.get("peer_replicate_every") or 0) > 0:
        raise ConfigError("checkpoint.peer_replicate_every > 0: peer-RAM replication is not ported")
    state = load_state(cfg.checkpoint.resume_from) if cfg.checkpoint.resume_from else None
    cfg.env.frame_stack = -1
    if 2 ** int(np.log2(cfg.env.screen_size)) != cfg.env.screen_size:
        raise ValueError(f"The screen size must be a power of 2, got: {cfg.env.screen_size}")
    log_dir = get_log_dir(cfg.root_dir, cfg.run_name)
    print(f"Log dir: {log_dir}")
    num_envs = int(cfg.env.num_envs)
    envs = vectorized_env([make_env(cfg, cfg.seed + i, 0, vector_env_idx=i) for i in range(num_envs)])
    action_space, observation_space = envs.single_action_space, envs.single_observation_space
    is_continuous = isinstance(action_space, spaces.Box)
    actions_dim = _actions_dim(action_space)
    algo = cfg.algo
    if (not set(algo.cnn_keys.encoder) & set(algo.cnn_keys.decoder)
            and not set(algo.mlp_keys.encoder) & set(algo.mlp_keys.decoder)):
        raise RuntimeError("The CNN keys or the MLP keys of the encoder and decoder must not be disjointed")
    if set(algo.cnn_keys.decoder) - set(algo.cnn_keys.encoder) or set(algo.mlp_keys.decoder) - set(algo.mlp_keys.encoder):
        raise RuntimeError("The decoder keys must be contained in the encoder ones")
    obs_keys = list(algo.cnn_keys.encoder) + list(algo.mlp_keys.encoder)

    world_model, actor, critic, target_critic, player = build_agent_fn(
        runtime, actions_dim, is_continuous, cfg, observation_space)
    trainer = trainer_cls(world_model, actor, critic, target_critic, cfg, runtime, is_continuous, actions_dim)
    if state:
        trainer.load_state_dict(state)
    save_configs(cfg, log_dir)
    player_keys = player.obs_keys(observation_space.keys())
    buffer_size = int(cfg.buffer.size) // num_envs if not cfg.dry_run else 2
    rb = EnvIndependentReplayBuffer(buffer_size, n_envs=num_envs, memmap=bool(cfg.buffer.memmap),
                                    memmap_dir=os.path.join(log_dir, "memmap_buffer"),
                                    buffer_cls=SequentialReplayBuffer)
    rb.seed(int(cfg.seed))
    gen = runtime.generator(cfg.seed)
    buffer_restored = bool(state and cfg.buffer.checkpoint and "rb" in state)
    if buffer_restored:
        rb.load_state_dict(state["rb"])

    train_step, cumulative_gradient_steps = 0, 0
    start_iter = int(state["iter_num"]) + 1 if state else 1
    policy_step = int(state["iter_num"]) * num_envs if state else 0
    last_log = int(state["last_log"]) if state else 0
    last_checkpoint = int(state["last_checkpoint"]) if state else 0
    total_iters = int(algo.total_steps // num_envs) if not cfg.dry_run else 1
    learning_starts = int(algo.learning_starts // num_envs) if not cfg.dry_run else 0
    prefill_steps = learning_starts - int(learning_starts > 0)
    if state:
        # as the JAX loop does: a resumed run trains again only learning_starts
        # iterations after start_iter, and the Ratio's count restarts there
        algo.per_rank_batch_size = int(state["batch_size"])
        learning_starts += start_iter
        prefill_steps += start_iter
    ratio = Ratio(float(algo.replay_ratio), pretrain_steps=int(algo.per_rank_pretrain_steps))
    if state:
        ratio.load_state_dict(state["ratio"])
        rng = state.get("rng")
        if isinstance(rng, dict) and "torch" in rng:
            gen.set_state(torch.from_numpy(np.asarray(rng["torch"], dtype=np.uint8).copy()))
            if buffer_restored:
                rb.set_rng_states(rng["rb"])
        else:
            print(f"The checkpoint's rng is not the port's (a JAX PRNG key): the port's generators are seeded "
                  f"from seed={cfg.seed}")
    if int(cfg.checkpoint.every) % num_envs != 0:
        warnings.warn(f"The checkpoint.every parameter ({cfg.checkpoint.every}) is not a multiple of the "
                      f"policy_steps_per_iter value ({num_envs}).")
    ckpt_callback = CheckpointCallback(keep_last=cfg.checkpoint.get("keep_last"))

    def save_checkpoint(iter_num: int) -> None:
        ckpt_state = dict(
            trainer.state_dict(), ratio=ratio.state_dict(), iter_num=iter_num,
            batch_size=int(algo.per_rank_batch_size), last_log=last_log, last_checkpoint=last_checkpoint,
            rng={"torch": gen.get_state().numpy(), "rb": rb.rng_states()},
        )
        ckpt_path = os.path.join(log_dir, "checkpoint", f"ckpt_{policy_step}_0.ckpt")
        ckpt_callback.on_checkpoint_coupled(ckpt_path, ckpt_state, rb if cfg.buffer.checkpoint else None)

    clip_rewards = np.tanh if cfg.env.clip_rewards else (lambda r: r)

    step_data: Dict[str, np.ndarray] = {}
    obs = envs.reset(seed=int(cfg.seed))[0]
    for k in obs_keys:
        step_data[k] = np.asarray(obs[k])[np.newaxis]
    zeros = np.zeros((1, num_envs, 1))
    step_data.update(rewards=zeros.copy(), truncated=zeros.copy(), terminated=zeros.copy(), is_first=np.ones_like(zeros))
    player.init_states()

    losses: List[Dict[str, float]] = []
    step_seconds: List[float] = []
    for iter_num in range(start_iter, total_iters + 1):
        policy_step += num_envs
        if iter_num <= learning_starts and state is None:
            real_actions = actions = np.array(envs.action_space.sample())
            if not is_continuous:
                actions = np.concatenate(
                    [np.eye(d, dtype=np.float32)[a.reshape(-1)] for a, d in zip(actions.reshape(len(actions_dim), -1), actions_dim)],
                    axis=-1)
        else:
            torch_obs = prepare_obs({k: obs[k] for k in player_keys}, runtime.device, cnn_keys=algo.cnn_keys.encoder,
                                    num_envs=num_envs)
            actions_list = player.get_actions(torch_obs, gen)
            actions = torch.cat(actions_list, dim=-1).cpu().numpy()
            real_actions = actions if is_continuous else np.stack(
                [a.argmax(dim=-1).cpu().numpy() for a in actions_list], axis=-1)
        step_data["actions"] = actions.reshape((1, num_envs, -1))
        rb.add(step_data)

        next_obs, rewards, terminated, truncated, infos = envs.step(real_actions.reshape(envs.action_space.shape))
        dones = np.logical_or(terminated, truncated).astype(np.uint8)
        if cfg.metric.log_level > 0:
            for i, ep_rew, ep_len in infos["episodes"]:
                print(f"Rank-0: policy_step={policy_step}, reward_env_{i}={ep_rew}, length={ep_len}")

        real_next_obs = {k: np.asarray(next_obs[k]).copy() for k in obs_keys}
        for idx, final_obs in infos["final_obs"].items():
            for k in obs_keys:
                real_next_obs[k][idx] = final_obs[k]
        for k in obs_keys:
            step_data[k] = np.asarray(next_obs[k])[np.newaxis]
        obs = next_obs
        step_data["is_first"] = np.zeros_like(step_data["terminated"])
        step_data["terminated"] = terminated.astype(np.float32).reshape((1, num_envs, -1))
        step_data["truncated"] = truncated.astype(np.float32).reshape((1, num_envs, -1))
        step_data["rewards"] = clip_rewards(np.asarray(rewards, dtype=np.float32).reshape((1, num_envs, -1)))

        dones_idxes = dones.nonzero()[0].tolist()
        if dones_idxes:
            reset_data = {k: real_next_obs[k][dones_idxes][np.newaxis] for k in obs_keys}
            reset_data["terminated"] = step_data["terminated"][:, dones_idxes]
            reset_data["truncated"] = step_data["truncated"][:, dones_idxes]
            reset_data["actions"] = np.zeros((1, len(dones_idxes), int(np.sum(actions_dim))))
            reset_data["rewards"] = step_data["rewards"][:, dones_idxes]
            reset_data["is_first"] = np.zeros_like(reset_data["terminated"])
            rb.add(reset_data, dones_idxes)
            for key in ("rewards", "terminated", "truncated"):
                step_data[key][:, dones_idxes] = 0.0
            step_data["is_first"][:, dones_idxes] = 1.0
            player.init_states(dones_idxes)

        if iter_num >= learning_starts:
            gradient_steps = ratio(policy_step - prefill_steps * num_envs)
            if gradient_steps > 0:
                batches = rb.sample(int(algo.per_rank_batch_size), n_samples=gradient_steps,
                                    sequence_length=int(algo.per_rank_sequence_length))
                batches = {k: torch.from_numpy(np.ascontiguousarray(v)).to(runtime.device, non_blocking=True)
                           for k, v in batches.items()}
                runtime.synchronize()
                t0 = time.perf_counter()
                metrics = torch.stack([trainer.train_step({k: v[i] for k, v in batches.items()}, gen)
                                       for i in range(gradient_steps)])
                runtime.synchronize()
                seconds = time.perf_counter() - t0
                if cumulative_gradient_steps > 0:
                    step_seconds.append(seconds / gradient_steps)
                cumulative_gradient_steps += gradient_steps
                train_step += gradient_steps
                row = dict(zip(trainer.metric_names, metrics.mean(dim=0).tolist()))
                losses.append(row)
                if cfg.metric.log_level > 0 and (policy_step - last_log >= cfg.metric.log_every or iter_num == total_iters):
                    print(f"policy_step={policy_step} gradient_steps={cumulative_gradient_steps} "
                                  + " ".join(f"{k}={v:.6g}" for k, v in row.items()))
                    last_log = policy_step

        if (int(cfg.checkpoint.every) > 0 and policy_step - last_checkpoint >= int(cfg.checkpoint.every)) or (
                iter_num == total_iters and cfg.checkpoint.save_last):
            last_checkpoint = policy_step
            save_checkpoint(iter_num)

    envs.close()
    if algo.run_test:
        test(player, runtime, cfg, gen, greedy=False)
    return {
        "gradient_steps": cumulative_gradient_steps,
        "losses": losses,
        "seconds_per_step": float(np.median(step_seconds)) if step_seconds else None,
        "log_dir": log_dir,
        "live": {"trainer": trainer, "rb": rb, "generator": gen, "ratio": ratio},
    }
