"""DreamerV3 agent of the port (counterpart of sheeprl_tpu/algos/dreamer_v3/agent.py).

Modules are ``nn.Module``s in PyTorch layouts. The RSSM's dynamic scan and
imagination step have three settings (``algo.world_model.kernels``):

- ``off``: the module-by-module loop over T, the twin of the flax path;
- ``auto`` (``on``, ``cuda``): the fused step of ``ops/rssm_step.py`` through
  its ``autograd.Function``s, which launch the CUDA kernels on a CUDA device
  and run their plain version on the CPU;
- ``reference``: the plain fused formulation under autograd, CPU only.

A configuration the fused step cannot take raises
:class:`~sheeprl_tpu_torch.ops.rssm_step.KernelUnsupported`; nothing falls back.
The decoupled RSSM (``world_model.decoupled_rssm``, the representation reads
only the embedding) has no fused step and runs the module path under
``kernels=off``. The MineDojo actor (``algo.actor.cls``) masks its rollout
samples with the env's ``mask*`` observations. Randomness arrives as explicit
Gumbel fields or ``torch.Generator``s.
"""

from __future__ import annotations

import copy
import math
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from sheeprl_tpu_torch.models.models import CNN, MLP, DeCNN, LayerNormGRUCell
from sheeprl_tpu_torch.ops import rssm_step as fused
from sheeprl_tpu_torch.ops.distributions import Independent, Normal, OneHotCategoricalStraightThrough, TanhNormal, gumbel
from sheeprl_tpu_torch.utils.utils import symlog

KERNEL_SETTINGS = ("off", "auto", "on", "cuda", "reference")


def uniform_mix(logits: torch.Tensor, discrete: int, unimix: float) -> torch.Tensor:
    """1% uniform mixture over each categorical of ``[..., stoch*discrete]`` logits."""
    shape = logits.shape
    logits = logits.reshape(*shape[:-1], -1, discrete)
    if unimix > 0.0:
        probs = torch.softmax(logits, dim=-1)
        probs = (1 - unimix) * probs + unimix / discrete
        logits = torch.log(probs.clamp_min(1e-12))
    return logits.reshape(shape)


def straight_through_sample(logits: torch.Tensor, discrete: int, g: Optional[torch.Tensor]) -> torch.Tensor:
    """``[..., S*D]`` logits -> ``[..., S, D]`` one-hot: the straight-through
    Gumbel-argmax sample with noise ``g``, or the mode when ``g`` is None."""
    logits = logits.reshape(*logits.shape[:-1], -1, discrete)
    dist = OneHotCategoricalStraightThrough(logits)
    if g is None:
        return dist.mode
    hard = F.one_hot((dist.logits.detach().float() + g).argmax(dim=-1), discrete).to(dist.logits.dtype)
    probs = dist.probs
    return hard + probs - probs.detach()


class CNNEncoder(nn.Module):
    """4-stage stride-2 image encoder, 64x64 -> 4x4, keys stacked on channels."""

    def __init__(self, keys, input_channels, image_size, channels_multiplier, layer_norm=True, eps=1e-3,
                 activation="silu", stages=4):
        super().__init__()
        self.keys = list(keys)
        self.output_dim = (2 ** (stages - 1)) * channels_multiplier * (image_size[0] // 2**stages) * (image_size[1] // 2**stages)
        self.cnn = CNN(sum(input_channels), [(2**i) * channels_multiplier for i in range(stages)],
                       {"kernel_size": 4, "stride": 2, "padding": 1, "bias": not layer_norm},
                       activation, layer_norm, {"eps": eps})

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = torch.cat([obs[k] for k in self.keys], dim=-3)
        batch_shape = x.shape[:-3]
        x = self.cnn(x.reshape(-1, *x.shape[-3:]))
        return x.reshape(*batch_shape, -1)


class MLPEncoder(nn.Module):
    def __init__(self, keys, input_dims, mlp_layers=4, dense_units=512, layer_norm=True, eps=1e-3,
                 activation="silu", symlog_inputs=True):
        super().__init__()
        self.keys = list(keys)
        self.symlog_inputs = symlog_inputs
        self.output_dim = dense_units
        self.mlp = MLP(sum(input_dims), None, [dense_units] * mlp_layers, activation, layer_norm, {"eps": eps},
                       use_bias=not layer_norm)

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.mlp(torch.cat([symlog(obs[k]) if self.symlog_inputs else obs[k] for k in self.keys], dim=-1))


class MultiEncoder(nn.Module):
    def __init__(self, cnn_encoder: Optional[CNNEncoder], mlp_encoder: Optional[MLPEncoder]):
        super().__init__()
        self.cnn_encoder, self.mlp_encoder = cnn_encoder, mlp_encoder
        self.output_dim = sum(m.output_dim for m in (cnn_encoder, mlp_encoder) if m is not None)

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        outs = [m(obs) for m in (self.cnn_encoder, self.mlp_encoder) if m is not None]
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)


class CNNDecoder(nn.Module):
    """Latent -> 4x4 features -> transposed convs -> image per key."""

    def __init__(self, keys, output_channels, channels_multiplier, latent_dim, cnn_encoder_output_dim, image_size,
                 layer_norm=True, eps=1e-3, activation="silu", stages=4):
        super().__init__()
        self.keys, self.output_channels = list(keys), list(output_channels)
        self.image_size = tuple(image_size)
        self.first_shape = ((2 ** (stages - 1)) * channels_multiplier, image_size[0] // 2**stages, image_size[1] // 2**stages)
        self.linear = nn.Linear(latent_dim, cnn_encoder_output_dim)
        out_ch = sum(output_channels)
        self.deconv = DeCNN(
            self.first_shape[0],
            [(2**i) * channels_multiplier for i in reversed(range(stages - 1))] + [out_ch],
            [{"kernel_size": 4, "stride": 2, "padding": 1, "bias": not layer_norm} for _ in range(stages - 1)]
            + [{"kernel_size": 4, "stride": 2, "padding": 1}],
            [activation] * (stages - 1) + [None],
            [layer_norm] * (stages - 1) + [False],
            {"eps": eps},
        )

    def forward(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        batch_shape = latent.shape[:-1]
        x = self.linear(latent.reshape(-1, latent.shape[-1])).reshape(-1, *self.first_shape)
        x = self.deconv(x).reshape(*batch_shape, -1, *self.image_size)
        return dict(zip(self.keys, torch.split(x, self.output_channels, dim=-3)))


class MLPDecoder(nn.Module):
    def __init__(self, keys, output_dims, latent_dim, mlp_layers=4, dense_units=512, layer_norm=True, eps=1e-3,
                 activation="silu"):
        super().__init__()
        self.mlp = MLP(latent_dim, None, [dense_units] * mlp_layers, activation, layer_norm, {"eps": eps},
                       use_bias=not layer_norm)
        self.heads = nn.ModuleDict({k: nn.Linear(dense_units, d) for k, d in zip(keys, output_dims)})

    def forward(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.mlp(latent)
        return {k: head(x) for k, head in self.heads.items()}


class MultiDecoder(nn.Module):
    def __init__(self, cnn_decoder: Optional[CNNDecoder], mlp_decoder: Optional[MLPDecoder]):
        super().__init__()
        self.cnn_decoder, self.mlp_decoder = cnn_decoder, mlp_decoder

    def forward(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        for m in (self.cnn_decoder, self.mlp_decoder):
            if m is not None:
                out.update(m(latent))
        return out


class RecurrentModel(nn.Module):
    """Linear projection + LayerNorm, then the Hafner LayerNorm GRU."""

    def __init__(self, input_size, recurrent_state_size, dense_units, layer_norm=True, eps=1e-3):
        super().__init__()
        self.mlp = MLP(input_size, None, [dense_units], None, layer_norm, {"eps": eps}, use_bias=not layer_norm)
        self.gru = LayerNormGRUCell(dense_units, recurrent_state_size, bias=False, layer_norm=True, layer_norm_eps=eps)

    def forward(self, x: torch.Tensor, recurrent_state: torch.Tensor) -> torch.Tensor:
        return self.gru(self.mlp(x), recurrent_state)


class MLPWithHead(nn.Module):
    """MLP trunk + linear head (representation, transition, reward, continue, critic)."""

    def __init__(self, input_dim, hidden_sizes, output_dim, activation="silu", layer_norm=True, eps=1e-3,
                 head_init_scale: float = 1.0):
        super().__init__()
        self.head_init_scale = head_init_scale
        self.mlp = (MLP(input_dim, None, hidden_sizes, activation, layer_norm, {"eps": eps}, use_bias=not layer_norm)
                    if len(hidden_sizes) > 0 else None)
        self.head = nn.Linear(hidden_sizes[-1] if hidden_sizes else input_dim, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.mlp(x) if self.mlp is not None else x)


class Actor(nn.Module):
    """DV3 actor: MLP trunk and one head per discrete action (or one mean/std
    head for continuous actions); distribution math in :class:`ActorOutput`."""

    #: whether the player hands the env's ``mask*`` observations to :meth:`sample`
    uses_action_mask = False

    def __init__(self, latent_state_size, actions_dim, is_continuous, distribution="auto", init_std=2.0,
                 min_std=0.1, max_std=1.0, dense_units=1024, mlp_layers=5, layer_norm=True, eps=1e-3,
                 activation="silu", unimix=0.01, action_clip=1.0):
        super().__init__()
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
        self.mlp = MLP(latent_state_size, None, [dense_units] * mlp_layers, activation, layer_norm, {"eps": eps},
                       use_bias=not layer_norm)
        outs = [2 * sum(self.actions_dim)] if is_continuous else list(self.actions_dim)
        self.heads = nn.ModuleList(nn.Linear(dense_units, o) for o in outs)

    def forward(self, state: torch.Tensor) -> List[torch.Tensor]:
        x = self.mlp(state)
        return [head(x) for head in self.heads]

    def sample(self, pre_dist: List[torch.Tensor], generator: torch.Generator, greedy: bool = False,
               mask: Optional[Dict[str, torch.Tensor]] = None) -> List[torch.Tensor]:
        """Env actions from the raw head outputs; subclasses may consume ``mask``."""
        return ActorOutput(self, pre_dist).sample_actions_with_raw(generator, greedy)[0]


class MinedojoActor(Actor):
    """DV3 actor for MineDojo: the parameters of :class:`Actor`; rollout-time
    sampling applies the env's action masks (:func:`sample_minedojo_actions`)."""

    uses_action_mask = True

    def sample(self, pre_dist, generator, greedy=False, mask=None):
        return sample_minedojo_actions(self, pre_dist, mask, generator, greedy)


def sample_minedojo_actions(actor: Actor, pre_dist: List[torch.Tensor], mask: Optional[Dict[str, torch.Tensor]],
                            generator: torch.Generator, greedy: bool = False) -> List[torch.Tensor]:
    """Sequential masked sampling over MineDojo's three heads: head 0 (action
    type), then heads 1 and 2, masked by what head 0 chose
    (:func:`minedojo_mask_logits`)."""
    if mask is None:
        return ActorOutput(actor, pre_dist).sample_actions_with_raw(generator, greedy)[0]
    actions: List[torch.Tensor] = []
    functional_action = None
    for i, logits in enumerate(pre_dist):
        logits = minedojo_mask_logits(uniform_mix(logits, logits.shape[-1], actor.unimix), i, mask, functional_action)
        dist = OneHotCategoricalStraightThrough(logits)
        actions.append(dist.mode if greedy else dist.rsample(generator))
        if functional_action is None:
            functional_action = actions[0].argmax(dim=-1)
    return actions


def minedojo_mask_logits(logits: torch.Tensor, head: int, mask: Dict[str, torch.Tensor],
                         functional_action: Optional[torch.Tensor]) -> torch.Tensor:
    """Set to -inf the logits of one MineDojo head that the env forbids. Head
    0: ``mask_action_type``. Head 1: ``mask_craft_smelt`` where the chosen
    action type is 15 (craft). Head 2: ``mask_equip_place`` for 16 and 17
    (equip, place), ``mask_destroy`` for 18 (destroy)."""

    def masked(m):
        m = torch.as_tensor(m, device=logits.device).bool().expand(logits.shape)
        return torch.where(m, logits, torch.full_like(logits, -math.inf))

    if head == 0:
        return masked(mask["mask_action_type"])
    if head == 1:
        return torch.where((functional_action == 15)[..., None], masked(mask["mask_craft_smelt"]), logits)
    is_equip_place = ((functional_action == 16) | (functional_action == 17))[..., None]
    out = torch.where(is_equip_place, masked(mask["mask_equip_place"]), logits)
    return torch.where((functional_action == 18)[..., None], masked(mask["mask_destroy"]), out)


#: the actor classes ``algo.actor.cls`` selects, by class name
ACTOR_CLASSES = {"Actor": Actor, "MinedojoActor": MinedojoActor}


class ActorOutput:
    """Distributions over the actor's raw head outputs."""

    def __init__(self, actor: Actor, pre_dist: List[torch.Tensor]):
        self.actor = actor
        if actor.is_continuous:
            mean, std = torch.chunk(pre_dist[0], 2, dim=-1)
            if actor.distribution == "tanh_normal":
                mean = 5 * torch.tanh(mean / 5)
                std = F.softplus(std + actor.init_std) + actor.min_std
                self.dists = [Independent(TanhNormal(mean, std), 1)]
            elif actor.distribution == "normal":
                self.dists = [Independent(Normal(mean, std), 1)]
            else:
                std = (actor.max_std - actor.min_std) * torch.sigmoid(std + actor.init_std) + actor.min_std
                self.dists = [Independent(Normal(torch.tanh(mean), std), 1)]
        else:
            self.dists = [OneHotCategoricalStraightThrough(uniform_mix(l, l.shape[-1], actor.unimix)) for l in pre_dist]

    def sample_actions_with_raw(self, generator: torch.Generator, greedy: bool = False):
        """(clipped actions, raw pre-clip samples); the env consumes the clipped ones."""
        if self.actor.is_continuous:
            actions = self.dists[0].mode if greedy else self.dists[0].rsample(generator)
            raw = actions
            if self.actor.action_clip > 0.0:
                clip = torch.full_like(actions, self.actor.action_clip)
                actions = actions * (clip / torch.maximum(clip, actions.abs())).detach()
            return [actions], [raw]
        samples = [d.mode if greedy else d.rsample(generator) for d in self.dists]
        return samples, samples

    def entropy(self) -> torch.Tensor:
        return sum(d.entropy() for d in self.dists)


def check_decoupled_kernels(decoupled: bool, kernels: str) -> None:
    """The fused step has no decoupled form: its posterior branch reads
    ``[h, e]``. Raise :class:`KernelUnsupported` for a decoupled RSSM under any
    setting but ``off``, which runs the module path; nothing falls back."""
    if decoupled and kernels != "off":
        raise fused.KernelUnsupported(
            f"world_model.decoupled_rssm=True: the fused RSSM step (world_model.kernels={kernels}) has no decoupled "
            "form, its posterior reads [h, e]; run the decoupled RSSM with world_model.kernels=off")


class RSSM(nn.Module):
    """Recurrent model, representation (posterior) and transition (prior) heads,
    and the learned initial recurrent state. ``decoupled``: the representation
    model reads only the embedding, so the posteriors of a whole sequence are
    one batched call before the recurrent scan."""

    def __init__(self, recurrent_model: RecurrentModel, representation_model: MLPWithHead,
                 transition_model: MLPWithHead, stochastic_size: int, discrete_size: int = 32,
                 unimix: float = 0.01, learnable_initial_recurrent_state: bool = True, kernels: str = "off",
                 compute_dtype: torch.dtype = torch.float32, decoupled: bool = False):
        super().__init__()
        # YAML reads ``off``/``on`` as booleans
        kernels = {"false": "off", "none": "off", "true": "on"}.get(str(kernels).lower(), str(kernels).lower())
        if kernels not in KERNEL_SETTINGS:
            raise ValueError(f"world_model.kernels must be one of {KERNEL_SETTINGS}, got {kernels!r}")
        check_decoupled_kernels(decoupled, kernels)
        self.decoupled = decoupled
        self.recurrent_model = recurrent_model
        self.representation_model = representation_model
        self.transition_model = transition_model
        self.stochastic_size, self.discrete_size, self.unimix = stochastic_size, discrete_size, unimix
        self.learnable_initial_recurrent_state = learnable_initial_recurrent_state
        self.initial_recurrent_state = nn.Parameter(torch.zeros(recurrent_model.gru.hidden_size),
                                                    requires_grad=learnable_initial_recurrent_state)
        self.kernels = kernels
        self.compute_dtype = compute_dtype

    @property
    def stoch_state_size(self) -> int:
        return self.stochastic_size * self.discrete_size

    # ----- the fused step's contract --------------------------------------------
    def fused_spec(self, embed_size: int, action_size: int) -> fused.RSSMStepSpec:
        """The step's static description; call after :func:`fused.extract_step_params`
        has checked the structure."""
        rec = self.recurrent_model
        return fused.RSSMStepSpec(
            action_size=int(action_size), embed_size=int(embed_size),
            dense_units=rec.mlp.linears[0].out_features, recurrent_size=rec.gru.hidden_size,
            trans_hidden=self.transition_model.mlp.linears[0].out_features,
            repr_hidden=self.representation_model.mlp.linears[0].out_features,
            stochastic=self.stochastic_size, discrete=self.discrete_size, unimix=float(self.unimix),
            eps_in=rec.mlp.norms[0].eps, eps_gru=rec.gru.eps,
            eps_trans=self.transition_model.mlp.norms[0].eps, eps_repr=self.representation_model.mlp.norms[0].eps,
            dtype={torch.float32: "float32", torch.bfloat16: "bfloat16"}[self.compute_dtype],
        )

    def _fused_args(self, device: torch.device, embed_size: int, action_size: int):
        p32 = fused.extract_step_params(self)
        spec = self.fused_spec(embed_size, action_size)
        custom_grad = self.kernels != "reference"
        if not custom_grad and device.type != "cpu":
            raise ValueError("world_model.kernels=reference runs the plain formulation, which is CPU only; "
                             "use kernels=auto on a CUDA device")
        return spec, p32, custom_grad

    # ----- module path ---------------------------------------------------------------
    def initial_states(self, batch_shape: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
        raw = self.initial_recurrent_state
        if not self.learnable_initial_recurrent_state:
            raw = raw.detach()
        recurrent_state = torch.tanh(raw).expand(*batch_shape, raw.shape[-1])
        _, prior = self._transition(recurrent_state, None)
        return recurrent_state, prior.reshape(*batch_shape, -1)

    def _transition(self, recurrent_out: torch.Tensor, g: Optional[torch.Tensor]):
        logits = uniform_mix(self.transition_model(recurrent_out), self.discrete_size, self.unimix)
        return logits, straight_through_sample(logits, self.discrete_size, g)

    def _representation(self, recurrent_state: Optional[torch.Tensor], embedded_obs: torch.Tensor,
                        g: Optional[torch.Tensor]):
        if self.decoupled:
            x = embedded_obs
        else:
            x = torch.cat([recurrent_state.to(embedded_obs.dtype), embedded_obs], dim=-1)
        logits = uniform_mix(self.representation_model(x), self.discrete_size, self.unimix)
        return logits, straight_through_sample(logits, self.discrete_size, g)

    def _recurrent(self, posterior_flat: torch.Tensor, action: torch.Tensor, recurrent_state: torch.Tensor):
        return self.recurrent_model(torch.cat([posterior_flat, action.to(posterior_flat.dtype)], dim=-1), recurrent_state)

    def dynamic_scan(self, embedded_obs: torch.Tensor, actions: torch.Tensor, is_first: torch.Tensor,
                     gumbel_field: torch.Tensor):
        """``[T, B, *]`` inputs and the ``[T, B, S, D]`` float32 Gumbel field of
        the posterior samples -> ``(recurrent_states [T,B,R], posteriors [T,B,S,D],
        priors_logits [T,B,S,D], posteriors_logits [T,B,S,D])``."""
        if self.kernels != "off":
            spec, p32, custom_grad = self._fused_args(embedded_obs.device, embedded_obs.shape[-1], actions.shape[-1])
            return fused.fused_dynamic_scan(p32, spec, self.initial_recurrent_state, embedded_obs, actions, is_first,
                                            gumbel_field, self.learnable_initial_recurrent_state, custom_grad)
        T, B = embedded_obs.shape[:2]
        rec = torch.zeros(B, self.recurrent_model.gru.hidden_size, dtype=embedded_obs.dtype, device=embedded_obs.device)
        if self.decoupled:
            return self._decoupled_scan(embedded_obs, actions, is_first, gumbel_field, rec)
        post = torch.zeros(B, self.stoch_state_size, dtype=embedded_obs.dtype, device=embedded_obs.device)
        outs = []
        for t in range(T):
            f = is_first[t]
            action = (1 - f) * actions[t]
            init_rec, init_post = self.initial_states((B,))
            rec = (1 - f) * rec + f * init_rec
            post = (1 - f) * post + f * init_post
            rec = self._recurrent(post, action, rec)
            prior_logits, _ = self._transition(rec, None)
            post_logits, posterior = self._representation(rec, embedded_obs[t], gumbel_field[t])
            post = posterior.reshape(B, -1)
            outs.append((rec, posterior, prior_logits, post_logits))
        recs, posts, priors_l, posts_l = (torch.stack(x) for x in zip(*outs))
        shape = (T, B, self.stochastic_size, self.discrete_size)
        return recs, posts, priors_l.reshape(shape), posts_l.reshape(shape)

    def _decoupled_scan(self, embedded_obs, actions, is_first, gumbel_field, rec):
        """The posteriors of all ``[T, B]`` at once from the embedding alone;
        the scan feeds step t the posterior of step t-1 (zeros at t=0)."""
        T, B = embedded_obs.shape[:2]
        posts_l, posts = self._representation(None, embedded_obs, gumbel_field)
        posts_flat = posts.reshape(T, B, -1)
        prev_posts = torch.cat([torch.zeros_like(posts_flat[:1]), posts_flat[:-1]], dim=0)
        recs, priors_l = [], []
        for t in range(T):
            f = is_first[t]
            action = (1 - f) * actions[t]
            init_rec, init_post = self.initial_states((B,))
            rec = (1 - f) * rec + f * init_rec
            prev_post = (1 - f) * prev_posts[t] + f * init_post
            rec = self._recurrent(prev_post, action, rec)
            recs.append(rec)
            priors_l.append(self._transition(rec, None)[0])
        shape = (T, B, self.stochastic_size, self.discrete_size)
        return torch.stack(recs), posts, torch.stack(priors_l).reshape(shape), posts_l.reshape(shape)

    def imagination_step(self, prior_flat: torch.Tensor, recurrent_state: torch.Tensor, actions: torch.Tensor,
                         gumbel_field: torch.Tensor, fused_args=None):
        """One imagined step from ``(prior [B,S*D], recurrent [B,R], action)``
        with the ``[B, S, D]`` Gumbel field of the prior sample; ``fused_args``
        (from :meth:`imagination_args`) carries the step's parameters cast once
        for the whole horizon."""
        if self.kernels != "off":
            spec, p32, custom_grad, pc = fused_args or self.imagination_args(recurrent_state.device, actions.shape[-1])
            return fused.fused_imagination_step(p32, spec, prior_flat, recurrent_state, actions, gumbel_field, pc,
                                                custom_grad)
        recurrent_state = self._recurrent(prior_flat, actions, recurrent_state)
        _, prior = self._transition(recurrent_state, gumbel_field)
        return prior.reshape(prior_flat.shape), recurrent_state

    def imagination_args(self, device: torch.device, action_size: int):
        spec, p32, custom_grad = self._fused_args(device, 0, action_size)
        return spec, p32, custom_grad, fused.compute_params(p32, spec) if custom_grad else None


class WorldModel(nn.Module):
    def __init__(self, encoder: MultiEncoder, rssm: RSSM, observation_model: MultiDecoder,
                 reward_model: MLPWithHead, continue_model: MLPWithHead):
        super().__init__()
        self.encoder, self.rssm, self.observation_model = encoder, rssm, observation_model
        self.reward_model, self.continue_model = reward_model, continue_model


class PlayerDV3:
    """Acts in the envs between updates, on the run's device: encoder ->
    recurrent model -> posterior sample -> actor, over explicit state tensors."""

    def __init__(self, world_model: WorldModel, actor: Actor, actions_dim: Sequence[int], num_envs: int, runtime):
        self.world_model, self.actor = world_model, actor
        self.actions_dim = tuple(actions_dim)
        self.num_envs = num_envs
        self.runtime = runtime
        self.state: Tuple[torch.Tensor, torch.Tensor, torch.Tensor] = ()

    @torch.no_grad()
    def init_states(self, reset_envs: Optional[Sequence[int]] = None) -> None:
        rssm = self.world_model.rssm
        dev = self.runtime.device
        init_rec, init_stoch = rssm.initial_states((1, self.num_envs))
        actions = torch.zeros(1, self.num_envs, sum(self.actions_dim), device=dev)
        if reset_envs is None or len(reset_envs) == 0:
            self.state = (init_rec.float(), init_stoch.float(), actions)
            return
        mask = torch.zeros(1, self.num_envs, 1, dtype=torch.bool, device=dev)
        mask[0, list(reset_envs)] = True
        rec, stoch, act = self.state
        self.state = (torch.where(mask, init_rec.float(), rec), torch.where(mask, init_stoch.float(), stoch),
                      torch.where(mask, torch.zeros_like(act), act))

    def obs_keys(self, available: Iterable[str]) -> List[str]:
        """The keys of the ``available`` observations that :meth:`get_actions`
        reads: the encoder's, and the env's ``mask*`` ones when the actor
        ``uses_action_mask``."""
        enc = self.world_model.encoder
        keys = [k for m in (enc.cnn_encoder, enc.mlp_encoder) if m is not None for k in m.keys]
        if self.actor.uses_action_mask:
            keys += [k for k in available if k.startswith("mask")]
        return keys

    @torch.no_grad()
    def get_actions(self, obs: Dict[str, torch.Tensor], generator: torch.Generator, greedy: bool = False):
        """Actions for the :meth:`obs_keys` of ``obs``; the ``mask*`` ones go to
        the actor's sampling. ``greedy`` takes the actor's mode; the posterior
        is sampled either way, as the JAX player samples it."""
        rssm = self.world_model.rssm
        mask = {k: v for k, v in obs.items() if k.startswith("mask")} or None
        rec, stoch, actions = self.state
        with self.runtime.autocast():
            embedded = self.world_model.encoder(obs)
            rec = rssm._recurrent(stoch, actions, rec)
            g = gumbel((*rec.shape[:-1], rssm.stochastic_size, rssm.discrete_size), generator, rec.device)
            _, post = rssm._representation(rec, embedded, g)
            stoch = post.reshape(*post.shape[:-2], -1)
            latent = torch.cat([stoch.float(), rec.float()], dim=-1)
            acts = self._actor_step(latent, generator, greedy, mask)
        acts = [a.float() for a in acts]
        self.state = (rec.float(), stoch.float(), torch.cat(acts, dim=-1))
        return acts

    def _actor_step(self, latent: torch.Tensor, generator: torch.Generator, greedy: bool,
                    mask: Optional[Dict[str, torch.Tensor]]) -> List[torch.Tensor]:
        """The actions of ``latent``; subclasses change how the actor is queried."""
        return self.actor.sample(self.actor(latent), generator, greedy, mask)


# --------------------------------------------------------------------------- #
# construction and Hafner initialisation
# --------------------------------------------------------------------------- #


def _ln_enabled(ln_cfg: Optional[Dict[str, Any]]) -> Tuple[bool, float]:
    """Reference-style layer_norm config ``{cls, kw: {eps}}`` -> (enabled, eps)."""
    if ln_cfg is None:
        return True, 1e-3
    cls = str(ln_cfg.get("cls", "LayerNorm"))
    return not cls.rsplit(".", 1)[-1].lower().startswith("identity"), float(ln_cfg.get("kw", {}).get("eps", 1e-3))


def _fans(w: torch.Tensor) -> Tuple[int, int]:
    receptive = math.prod(w.shape[2:]) if w.dim() > 2 else 1
    return w.shape[1] * receptive, w.shape[0] * receptive


@torch.no_grad()
def _trunc_normal_(w: torch.Tensor, fan: float, gen: torch.Generator) -> None:
    # variance_scaling(1.0, fan, "truncated_normal"): the std of a normal cut at +-2 std
    std = math.sqrt(1.0 / fan) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)


@torch.no_grad()
def _uniform_(w: torch.Tensor, scale: float, fan: float, gen: torch.Generator) -> None:
    if scale == 0.0:
        w.zero_()
        return
    limit = math.sqrt(3.0 * scale / fan)
    nn.init.uniform_(w, -limit, limit, generator=gen)


@torch.no_grad()
def hafner_init_(module: nn.Module, gen: torch.Generator, heads: Dict[nn.Module, float]) -> None:
    """Trunc-normal fan-avg for every weight, fan-avg uniform with the given
    scale for the ``heads`` (scale < 0: lecun normal), zero biases."""
    for m in module.modules():
        weight = getattr(m, "weight", None)
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d, LayerNormGRUCell)):
            fan_in, fan_out = _fans(weight)
            if m in heads and heads[m] >= 0:
                _uniform_(weight, heads[m], (fan_in + fan_out) / 2, gen)
            elif m in heads:
                _trunc_normal_(weight, fan_in, gen)
            else:
                _trunc_normal_(weight, (fan_in + fan_out) / 2, gen)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()


def build_agent(runtime, actions_dim: Sequence[int], is_continuous: bool, cfg, obs_space, build_actor: bool = True):
    """Modules with Hafner init, on the run's device:
    ``(world_model, actor, critic, target_critic, player)``. With
    ``build_actor=False`` the actor and the player are ``None``, for callers
    that bring their own actor (Dream-and-Ponder)."""
    wm_cfg, actor_cfg, critic_cfg = cfg.algo.world_model, cfg.algo.actor, cfg.algo.critic
    decoupled = bool(wm_cfg.get("decoupled_rssm", False))
    actor_cls = ACTOR_CLASSES.get(str(actor_cfg.get("cls", "Actor")).rsplit(".", 1)[-1])
    if build_actor and actor_cls is None:
        raise ValueError(f"algo.actor.cls={actor_cfg.get('cls')!r}: expected one of {sorted(ACTOR_CLASSES)}")
    recurrent_state_size = int(wm_cfg.recurrent_model.recurrent_state_size)
    stoch_flat = int(wm_cfg.stochastic_size) * int(wm_cfg.discrete_size)
    latent_size = stoch_flat + recurrent_state_size
    stages = int(np.log2(cfg.env.screen_size) - np.log2(4))
    cnn_keys, mlp_keys = list(cfg.algo.cnn_keys.encoder), list(cfg.algo.mlp_keys.encoder)
    cnn_keys_dec, mlp_keys_dec = list(cfg.algo.cnn_keys.decoder), list(cfg.algo.mlp_keys.decoder)
    hafner = bool(cfg.algo.hafner_initialization)

    cnn_ln, cnn_eps = _ln_enabled(wm_cfg.encoder.get("cnn_layer_norm"))
    mlp_ln, mlp_eps = _ln_enabled(wm_cfg.encoder.get("mlp_layer_norm"))
    cnn_encoder = CNNEncoder(
        cnn_keys, [int(np.prod(obs_space[k].shape[:-2])) for k in cnn_keys], tuple(obs_space[cnn_keys[0]].shape[-2:]),
        int(wm_cfg.encoder.cnn_channels_multiplier), cnn_ln, cnn_eps, wm_cfg.encoder.cnn_act, stages,
    ) if cnn_keys else None
    mlp_encoder = MLPEncoder(
        mlp_keys, [int(obs_space[k].shape[0]) for k in mlp_keys], int(wm_cfg.encoder.mlp_layers),
        int(wm_cfg.encoder.dense_units), mlp_ln, mlp_eps, wm_cfg.encoder.dense_act,
    ) if mlp_keys else None
    encoder = MultiEncoder(cnn_encoder, mlp_encoder)

    rec_ln, rec_eps = _ln_enabled(wm_cfg.recurrent_model.get("layer_norm"))
    recurrent_model = RecurrentModel(int(sum(actions_dim)) + stoch_flat, recurrent_state_size,
                                     int(wm_cfg.recurrent_model.dense_units), rec_ln, rec_eps)
    repr_ln, repr_eps = _ln_enabled(wm_cfg.representation_model.get("layer_norm"))
    representation_model = MLPWithHead(encoder.output_dim + (0 if decoupled else recurrent_state_size),
                                       [int(wm_cfg.representation_model.hidden_size)], stoch_flat,
                                       wm_cfg.representation_model.dense_act, repr_ln, repr_eps, 1.0 if hafner else -1.0)
    trans_ln, trans_eps = _ln_enabled(wm_cfg.transition_model.get("layer_norm"))
    transition_model = MLPWithHead(recurrent_state_size, [int(wm_cfg.transition_model.hidden_size)], stoch_flat,
                                   wm_cfg.transition_model.dense_act, trans_ln, trans_eps, 1.0 if hafner else -1.0)
    rssm = RSSM(recurrent_model, representation_model, transition_model, int(wm_cfg.stochastic_size),
                int(wm_cfg.discrete_size), float(cfg.algo.unimix),
                bool(wm_cfg.get("learnable_initial_recurrent_state", True)), str(wm_cfg.get("kernels", "off")),
                runtime.compute_dtype, decoupled)

    obs_cnn_ln, obs_cnn_eps = _ln_enabled(wm_cfg.observation_model.get("cnn_layer_norm"))
    obs_mlp_ln, obs_mlp_eps = _ln_enabled(wm_cfg.observation_model.get("mlp_layer_norm"))
    cnn_decoder = CNNDecoder(
        cnn_keys_dec, [int(np.prod(obs_space[k].shape[:-2])) for k in cnn_keys_dec],
        int(wm_cfg.observation_model.cnn_channels_multiplier), latent_size, cnn_encoder.output_dim,
        tuple(obs_space[cnn_keys_dec[0]].shape[-2:]), obs_cnn_ln, obs_cnn_eps, wm_cfg.observation_model.cnn_act, stages,
    ) if cnn_keys_dec else None
    mlp_decoder = MLPDecoder(
        mlp_keys_dec, [int(obs_space[k].shape[0]) for k in mlp_keys_dec], latent_size,
        int(wm_cfg.observation_model.mlp_layers), int(wm_cfg.observation_model.dense_units), obs_mlp_ln, obs_mlp_eps,
        wm_cfg.observation_model.dense_act,
    ) if mlp_keys_dec else None
    observation_model = MultiDecoder(cnn_decoder, mlp_decoder)

    def head_model(sub_cfg, out_dim, scale):
        ln, eps = _ln_enabled(sub_cfg.get("layer_norm"))
        return MLPWithHead(latent_size, [int(sub_cfg.dense_units)] * int(sub_cfg.mlp_layers), out_dim,
                           sub_cfg.dense_act, ln, eps, scale if hafner else -1.0)

    reward_model = head_model(wm_cfg.reward_model, int(wm_cfg.reward_model.bins), 0.0)
    continue_model = head_model(wm_cfg.discount_model, 1, 1.0)
    world_model = WorldModel(encoder, rssm, observation_model, reward_model, continue_model)

    actor = None
    if build_actor:
        actor_ln, actor_eps = _ln_enabled(actor_cfg.get("layer_norm"))
        actor = actor_cls(latent_size, actions_dim, is_continuous, cfg.distribution.get("type", "auto"),
                          float(actor_cfg.init_std), float(actor_cfg.min_std), float(actor_cfg.get("max_std", 1.0)),
                          int(actor_cfg.dense_units), int(actor_cfg.mlp_layers), actor_ln, actor_eps,
                          actor_cfg.dense_act, float(cfg.algo.unimix), float(actor_cfg.get("action_clip", 1.0)))
    critic = head_model(critic_cfg, int(critic_cfg.bins), 0.0)

    heads: Dict[nn.Module, float] = {m.head: m.head_init_scale for m in
                                     (representation_model, transition_model, reward_model, continue_model, critic)}
    if cnn_decoder is not None:
        heads[cnn_decoder.deconv.deconvs[-1]] = 1.0
    if mlp_decoder is not None:
        heads.update({h: 1.0 for h in mlp_decoder.heads.values()})
    gen = torch.Generator().manual_seed(int(cfg.seed))
    modules = [world_model, critic]
    if actor is not None:
        heads.update({h: 1.0 for h in actor.heads})
        modules.insert(1, actor)
    for module in modules:
        hafner_init_(module, gen, heads)
    world_model, critic = world_model.to(runtime.device), critic.to(runtime.device)
    target_critic = copy.deepcopy(critic).requires_grad_(False)
    if actor is None:
        return world_model, None, critic, target_critic, None
    actor = actor.to(runtime.device)
    player = PlayerDV3(world_model, actor, actions_dim, int(cfg.env.num_envs), runtime)
    return world_model, actor, critic, target_critic, player
