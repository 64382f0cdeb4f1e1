"""The decoupled RSSM and the MineDojo actor of the port against the JAX
package's, on the CPU at the ``TINY`` config of ``tests/test_torch_dreamer_v3.py``.

- Decoupled RSSM (``world_model.decoupled_rssm=True``, ``kernels=off`` on both
  sides): the world-model loss and its gradients, with the posterior Gumbel
  field the JAX scan draws (``split(fold_in(key, 1), T)``, one key a step);
  float32, losses rtol 1e-4, gradients normwise 1e-4. Under any other
  ``kernels`` setting the port raises, naming the field.
- One player step, coupled and decoupled, greedy and sampled, against the JAX
  player's ``_raw_step`` with the noise its keys draw: equal one-hot actions
  and posteriors (one-hots up to the straight-through term's rounding, atol
  1e-6), recurrent state rtol 1e-4 / atol 1e-5.
- MineDojo: masked logits equal ``minedojo_mask_logits`` exactly for all three
  heads and the action types 15-18; greedy actions equal the JAX ones; sampled
  actions never take a masked entry; ``algo.actor.cls`` selects the actor and
  the player hands it the ``mask*`` observations.
"""

import types

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3 import agent as jagent
from sheeprl_tpu.config import compose as jcompose
from sheeprl_tpu_torch.algos.dreamer_v3 import agent as tagent
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3Trainer
from sheeprl_tpu_torch.compat import flax_params
from sheeprl_tpu_torch.config import compose as tcompose
from sheeprl_tpu_torch.core.runtime import Runtime
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.ops import distributions as tdist
from sheeprl_tpu_torch.ops.rssm_step import KernelUnsupported
from tests.test_torch_dreamer_v3 import TINY, B, T, _batch, _jax_world_loss, _JaxRuntime

MODULE_PATH = [o for o in TINY if not o.startswith("algo.world_model.kernels=")] + ["algo.world_model.kernels=off"]
DECOUPLED = MODULE_PATH + ["algo.world_model.decoupled_rssm=True"]
N_ENVS = 4


def _build(overrides, actions_dim=(2,)):
    jcfg, tcfg = jcompose("config", overrides), tcompose(overrides + ["fabric.accelerator=cpu"])
    jobs = gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, (3, 16, 16), np.uint8),
                            "state": gym.spaces.Box(-20, 20, (10,), np.float32)})
    tobs = spaces.Dict({"rgb": spaces.Box(0, 255, (3, 16, 16), np.uint8), "state": spaces.Box(-20, 20, (10,))})
    modules, params, jplayer = jagent.build_agent(_JaxRuntime(), actions_dim, False, jcfg, jobs)
    runtime = Runtime(accelerator="cpu", precision="32-true")
    wm, actor, critic, target, tplayer = tagent.build_agent(runtime, actions_dim, False, tcfg, tobs)
    wm.load_state_dict(flax_params.world_model_state_dict(jax.device_get(params["world_model"])), strict=True)
    actor.load_state_dict(flax_params.to_state_dict(jax.device_get(params["actor"])), strict=True)
    return types.SimpleNamespace(jcfg=jcfg, tcfg=tcfg, modules=modules, params=params, jplayer=jplayer, wm=wm,
                                 actor=actor, critic=critic, target=target, tplayer=tplayer, runtime=runtime)


@pytest.fixture(scope="module")
def agents():
    return {"coupled": _build(MODULE_PATH), "decoupled": _build(DECOUPLED)}


class _Noise:
    """Prepared Gumbel fields handed out in order, in place of the port's draws
    from its generator (the JAX package draws from keys)."""

    def __init__(self, fields):
        self.fields = [np.array(f, np.float32) for f in fields]

    def __call__(self, shape, generator, device, dtype=torch.float32):
        field = self.fields.pop(0)
        assert field.shape == tuple(shape), (field.shape, tuple(shape))
        return torch.as_tensor(field, dtype=dtype, device=device)


# --------------------------------------------------------------------------- #
# decoupled RSSM
# --------------------------------------------------------------------------- #


def test_decoupled_world_model_loss_and_grads_match_jax(agents):
    a = agents["decoupled"]
    assert a.wm.rssm.decoupled and a.modules.rssm.decoupled
    assert a.wm.rssm.representation_model.mlp.linears[0].in_features == a.wm.encoder.output_dim
    data = _batch(np.random.default_rng(3))
    key = jax.random.PRNGKey(5)
    loss_fn = jax.value_and_grad(lambda p, d: _jax_world_loss(a.modules, a.jcfg, p, d, key), has_aux=True)
    (j_loss, j_parts), j_grads = jax.jit(loss_fn)(a.params["world_model"], {k: jnp.asarray(v) for k, v in data.items()})
    s, d = int(a.jcfg.algo.world_model.stochastic_size), int(a.jcfg.algo.world_model.discrete_size)
    post_keys = jax.random.split(jax.random.fold_in(key, 1), T)
    g = np.stack([np.asarray(jax.random.gumbel(k, (B, s, d), jnp.float32)) for k in post_keys])

    trainer = DV3Trainer(a.wm, a.actor, a.critic, a.target, a.tcfg, a.runtime, False, [2])
    a.wm.zero_grad()
    t_loss, aux = trainer.world_loss({k: torch.tensor(v) for k, v in data.items()}, torch.tensor(g))
    t_loss.backward()

    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss), rtol=1e-4)
    for name, ref in zip(("kl", "state_loss", "reward_loss", "observation_loss", "continue_loss"), j_parts[1:]):
        np.testing.assert_allclose(float(aux[name].detach()), float(ref), rtol=1e-4, atol=1e-5, err_msg=name)
    ref_grads = flax_params.world_model_state_dict(jax.device_get(j_grads))
    got = dict(a.wm.named_parameters())
    assert set(ref_grads) == set(got)
    for name, ref in ref_grads.items():
        grad = got[name].grad
        ref = ref.numpy()
        err = 0.0 if grad is None else float(np.max(np.abs(grad.numpy() - ref)))
        assert err <= 1e-4 * float(np.max(np.abs(ref))) + 1e-7, f"{name}: max|d|={err:.3e}"


@pytest.mark.parametrize("kernels", ["auto", "on", "cuda", "reference"])
def test_decoupled_rssm_refuses_the_fused_step(kernels):
    with pytest.raises(KernelUnsupported, match=r"world_model\.decoupled_rssm=True"):
        tagent.check_decoupled_kernels(True, kernels)
    tagent.check_decoupled_kernels(False, kernels)
    tagent.check_decoupled_kernels(True, "off")
    cfg = tcompose(DECOUPLED + [f"algo.world_model.kernels={kernels}", "fabric.accelerator=cpu"])
    obs = spaces.Dict({"rgb": spaces.Box(0, 255, (3, 16, 16), np.uint8), "state": spaces.Box(-20, 20, (10,))})
    with pytest.raises(KernelUnsupported, match=r"world_model\.decoupled_rssm"):
        tagent.build_agent(Runtime(accelerator="cpu", precision="32-true"), (2,), False, cfg, obs)


@pytest.mark.parametrize("greedy", [False, True])
@pytest.mark.parametrize("variant", ["coupled", "decoupled"])
def test_player_step_matches_jax(agents, variant, greedy):
    a = agents[variant]
    rng = np.random.default_rng(7)
    s, d = a.tplayer.world_model.rssm.stochastic_size, a.tplayer.world_model.rssm.discrete_size
    R = a.tplayer.world_model.rssm.recurrent_model.gru.hidden_size
    state = (np.tanh(rng.standard_normal((1, N_ENVS, R))).astype(np.float32),
             np.eye(d, dtype=np.float32)[rng.integers(0, d, (1, N_ENVS, s))].reshape(1, N_ENVS, s * d),
             np.eye(2, dtype=np.float32)[rng.integers(0, 2, (1, N_ENVS))])
    obs = {"rgb": (rng.integers(0, 256, (1, N_ENVS, 3, 16, 16)) / 255.0 - 0.5).astype(np.float32),
           "state": rng.standard_normal((1, N_ENVS, 10)).astype(np.float32)}
    key = jax.random.PRNGKey(9)
    j_acts, j_state = a.jplayer._raw_step(a.params["world_model"], a.params["actor"], tuple(map(jnp.asarray, state)),
                                          {k: jnp.asarray(v) for k, v in obs.items()}, key, greedy=greedy)
    k_rep, k_act = jax.random.split(key)
    fields = [jax.random.gumbel(k_rep, (1, N_ENVS, s, d), jnp.float32)]
    if not greedy:
        fields.append(jax.random.gumbel(jax.random.split(k_act, 1)[0], (1, N_ENVS, 2), jnp.float32))
    noise = _Noise(fields)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tagent, "gumbel", noise)
        mp.setattr(tdist, "gumbel", noise)
        a.tplayer.num_envs = N_ENVS
        a.tplayer.state = tuple(torch.tensor(x) for x in state)
        t_acts = a.tplayer.get_actions({k: torch.tensor(v) for k, v in obs.items()}, torch.Generator(), greedy)
    assert not noise.fields
    # one-hots up to the rounding of the straight-through term (hard + probs - probs)
    np.testing.assert_allclose(t_acts[0].numpy(), np.asarray(j_acts[0]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(a.tplayer.state[0].numpy(), np.asarray(j_state[0]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(a.tplayer.state[1].numpy(), np.asarray(j_state[1]), rtol=0, atol=1e-6)


# --------------------------------------------------------------------------- #
# MineDojo actor
# --------------------------------------------------------------------------- #

MINEDOJO_DIMS = (19, 6, 5)  # action type (15 craft, 16 equip, 17 place, 18 destroy), craft target, item


def _masks(rng, n):
    def mask(width):
        m = rng.random((n, width)) < 0.5
        m[np.arange(n), rng.integers(0, width, n)] = True  # at least one allowed entry a row
        return m

    return {"mask_action_type": mask(MINEDOJO_DIMS[0]), "mask_craft_smelt": mask(MINEDOJO_DIMS[1]),
            "mask_equip_place": mask(MINEDOJO_DIMS[2]), "mask_destroy": mask(MINEDOJO_DIMS[2])}


def test_minedojo_mask_logits_match_jax_exactly():
    rng = np.random.default_rng(0)
    n = 64
    masks = _masks(rng, n)
    functional = np.concatenate([np.repeat([15, 16, 17, 18], 8), rng.integers(0, 15, n - 32)])
    assert set(functional) >= {15, 16, 17, 18}
    for head, width in enumerate(MINEDOJO_DIMS):
        logits = rng.standard_normal((n, width)).astype(np.float32)
        ref = jagent.minedojo_mask_logits(jnp.asarray(logits), head, {k: jnp.asarray(v) for k, v in masks.items()},
                                          None if head == 0 else jnp.asarray(functional))
        got = tagent.minedojo_mask_logits(torch.tensor(logits), head, {k: torch.tensor(v) for k, v in masks.items()},
                                          None if head == 0 else torch.tensor(functional))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref), err_msg=f"head {head}")
        assert np.isneginf(got.numpy()).any()


def _allowed(actions, masks):
    """Whether each sampled row respects the env masks, given its action type."""
    a0, a1, a2 = (x.argmax(-1) for x in actions)
    rows = np.arange(len(a0))
    ok = masks["mask_action_type"][rows, a0]
    ok &= np.where(a0 == 15, masks["mask_craft_smelt"][rows, a1], True)
    ok &= np.where((a0 == 16) | (a0 == 17), masks["mask_equip_place"][rows, a2], True)
    ok &= np.where(a0 == 18, masks["mask_destroy"][rows, a2], True)
    return ok


def test_minedojo_sampling_respects_masks_and_greedy_matches_jax():
    rng = np.random.default_rng(1)
    n = 2048
    masks = _masks(rng, n)
    # push the action type towards 15-18, so the conditional heads are exercised
    logits = [rng.standard_normal((n, w)).astype(np.float32) for w in MINEDOJO_DIMS]
    logits[0][:, 15:19] += 2.0
    actor = types.SimpleNamespace(unimix=0.01)
    t_masks = {k: torch.tensor(v) for k, v in masks.items()}
    sampled = tagent.sample_minedojo_actions(actor, [torch.tensor(x) for x in logits], t_masks,
                                             torch.Generator().manual_seed(0))
    sampled = [s.numpy() for s in sampled]
    assert all(np.allclose(s.sum(-1), 1.0) for s in sampled)
    assert _allowed(sampled, masks).all()
    assert set(sampled[0].argmax(-1)) >= {15, 16, 17, 18}

    greedy = tagent.sample_minedojo_actions(actor, [torch.tensor(x) for x in logits], t_masks, None, greedy=True)
    ref = jagent.sample_minedojo_actions(actor, [jnp.asarray(x) for x in logits],
                                         {k: jnp.asarray(v) for k, v in masks.items()}, jax.random.PRNGKey(0),
                                         greedy=True)
    for got, want in zip(greedy, ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert _allowed([g.numpy() for g in greedy], masks).all()


def test_minedojo_actor_is_selected_and_the_player_masks():
    overrides = MODULE_PATH + ["algo.actor.cls=sheeprl_tpu_torch.algos.dreamer_v3.agent.MinedojoActor"]
    cfg = tcompose(overrides + ["fabric.accelerator=cpu"])
    obs_space = spaces.Dict({"rgb": spaces.Box(0, 255, (3, 16, 16), np.uint8), "state": spaces.Box(-20, 20, (10,))})
    runtime = Runtime(accelerator="cpu", precision="32-true")
    _, actor, _, _, player = tagent.build_agent(runtime, MINEDOJO_DIMS, False, cfg, obs_space)
    assert isinstance(actor, tagent.MinedojoActor) and actor.uses_action_mask
    rng = np.random.default_rng(2)
    n = 256
    masks = _masks(rng, n)
    player.num_envs = n
    player.init_states()
    obs = {"rgb": torch.rand(1, n, 3, 16, 16) - 0.5, "state": torch.randn(1, n, 10)}
    obs.update({k: torch.tensor(v[None]).float() for k, v in masks.items()})
    assert player.obs_keys([*obs, "other"]) == [*cfg.algo.cnn_keys.encoder, *cfg.algo.mlp_keys.encoder, *masks]
    actions = player.get_actions(obs, torch.Generator().manual_seed(0))
    assert [a.shape[-1] for a in actions] == list(MINEDOJO_DIMS)
    assert _allowed([a[0].numpy() for a in actions], masks).all()
    with pytest.raises(ValueError, match="algo.actor.cls"):
        tagent.build_agent(runtime, MINEDOJO_DIMS, False,
                           tcompose(MODULE_PATH + ["algo.actor.cls=some.module.OtherActor", "fabric.accelerator=cpu"]),
                           obs_space)
