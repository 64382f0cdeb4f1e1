"""The slice as a whole on the CPU: the port's DreamerV3 world-model loss and
its gradients against the JAX package's, both with
``algo.world_model.kernels=reference``, on one fixed batch, the same converted
parameters and the same Gumbel field (the one the JAX scan draws from
``fold_in(key, 1)``).

The JAX side composes its own modules exactly as ``world_loss_fn`` does in
``sheeprl_tpu/algos/dreamer_v3/dreamer_v3.py:169-218``. Float32: losses rtol
1e-4, gradients normwise 1e-4 of each parameter's largest entry.
"""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3 import agent as jagent
from sheeprl_tpu.algos.dreamer_v3.loss import reconstruction_loss as j_reconstruction_loss
from sheeprl_tpu.config import compose as jcompose
from sheeprl_tpu.ops import distributions as jd
from sheeprl_tpu_torch.algos.dreamer_v3 import agent as tagent
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3Trainer
from sheeprl_tpu_torch.compat import flax_params
from sheeprl_tpu_torch.config import compose as tcompose
from sheeprl_tpu_torch.core.runtime import Runtime
from sheeprl_tpu_torch.envs import spaces

TINY = [
    "exp=dreamer_v3", "env=dummy", "fabric.precision=32-true", "env.screen_size=16", "algo.dense_units=8",
    "algo.mlp_layers=1", "algo.world_model.encoder.cnn_channels_multiplier=2",
    "algo.world_model.recurrent_model.recurrent_state_size=8", "algo.world_model.transition_model.hidden_size=8",
    "algo.world_model.representation_model.hidden_size=8", "algo.world_model.stochastic_size=3",
    "algo.world_model.discrete_size=4", "algo.mlp_keys.encoder=[state]", "algo.mlp_keys.decoder=[state]",
    "algo.world_model.kernels=reference",
]
T, B = 5, 3


class _JaxRuntime:
    compute_dtype = jnp.float32


def _batch(rng):
    is_first = (rng.random((T, B, 1)) < 0.2).astype(np.float32)
    return {
        "rgb": rng.integers(0, 256, (T, B, 3, 16, 16), dtype=np.uint8),
        "state": rng.standard_normal((T, B, 10)).astype(np.float32),
        "actions": np.eye(2, dtype=np.float32)[rng.integers(0, 2, (T, B))],
        "rewards": rng.standard_normal((T, B, 1)).astype(np.float32),
        "terminated": (rng.random((T, B, 1)) < 0.1).astype(np.float32),
        "is_first": is_first,
    }


def _jax_world_loss(modules, cfg, wm_params, data, key):
    """The JAX package's world-model loss, composed as in its train step."""
    wm_cfg = cfg.algo.world_model
    batch_obs = {"rgb": data["rgb"].astype(jnp.float32) / 255.0 - 0.5, "state": data["state"]}
    is_first = data["is_first"].at[0].set(1.0)
    actions = data["actions"]
    batch_actions = jnp.concatenate([jnp.zeros_like(actions[:1]), actions[:-1]], axis=0)
    embedded = modules.encoder.apply(wm_params["encoder"], batch_obs)
    rec, posteriors, priors_logits, posteriors_logits = modules.rssm.dynamic_scan(
        wm_params, embedded, batch_actions, is_first, key)
    latent = jnp.concatenate([posteriors.reshape(*posteriors.shape[:-2], -1), rec], axis=-1)
    recon = modules.observation_model.apply(wm_params["observation_model"], latent)
    po = {"rgb": jd.MSEDistribution(recon["rgb"], dims=3).log_prob(batch_obs["rgb"]),
          "state": jd.SymlogDistribution(recon["state"], dims=1).log_prob(batch_obs["state"])}
    pr = jd.TwoHotEncodingDistribution(modules.reward_model.apply(wm_params["reward_model"], latent), dims=1)
    pc = jd.Independent(jd.BernoulliSafeMode(logits=modules.continue_model.apply(wm_params["continue_model"], latent)), 1)
    out = j_reconstruction_loss(po, pr.log_prob(data["rewards"]), priors_logits, posteriors_logits,
                                float(wm_cfg.kl_dynamic), float(wm_cfg.kl_representation), float(wm_cfg.kl_free_nats),
                                float(wm_cfg.kl_regularizer), pc.log_prob(1.0 - data["terminated"]),
                                float(wm_cfg.continue_scale_factor))
    return out[0], out


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = jcompose("config", TINY), tcompose(TINY + ["fabric.accelerator=cpu"])
    jobs = gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, (3, 16, 16), np.uint8),
                            "state": gym.spaces.Box(-20, 20, (10,), np.float32)})
    tobs = spaces.Dict({"rgb": spaces.Box(0, 255, (3, 16, 16), np.uint8), "state": spaces.Box(-20, 20, (10,))})
    modules, params, _ = jagent.build_agent(_JaxRuntime(), (2,), False, jcfg, jobs)
    runtime = Runtime(accelerator="cpu", precision="32-true")
    wm, actor, critic, target, _ = tagent.build_agent(runtime, (2,), False, tcfg, tobs)
    wm.load_state_dict(flax_params.world_model_state_dict(jax.device_get(params["world_model"])), strict=True)
    trainer = DV3Trainer(wm, actor, critic, target, tcfg, runtime, False, [2])
    return modules, params, jcfg, wm, trainer


def test_world_model_loss_and_grads_match_jax(setup):
    modules, params, jcfg, wm, trainer = setup
    data = _batch(np.random.default_rng(0))
    key = jax.random.PRNGKey(11)
    loss_fn = jax.jit(jax.value_and_grad(lambda p, d: _jax_world_loss(modules, jcfg, p, d, key), has_aux=True))
    (j_loss, j_parts), j_grads = loss_fn(params["world_model"], {k: jnp.asarray(v) for k, v in data.items()})
    s, d = int(jcfg.algo.world_model.stochastic_size), int(jcfg.algo.world_model.discrete_size)
    gumbel = np.asarray(jax.random.gumbel(jax.random.fold_in(key, 1), (T, B, s, d), jnp.float32))

    wm.zero_grad()
    t_loss, aux = trainer.world_loss({k: torch.tensor(v) for k, v in data.items()}, torch.tensor(gumbel))
    t_loss.backward()

    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss), rtol=1e-4)
    names = ("kl", "state_loss", "reward_loss", "observation_loss", "continue_loss")
    for name, ref in zip(names, j_parts[1:]):
        np.testing.assert_allclose(float(aux[name].detach()), float(ref), rtol=1e-4, atol=1e-5, err_msg=name)
    ref_grads = flax_params.world_model_state_dict(jax.device_get(j_grads))
    got = dict(wm.named_parameters())
    assert set(ref_grads) == set(got)
    for name, ref in ref_grads.items():
        g = got[name].grad
        ref = ref.numpy()
        err = 0.0 if g is None else float(np.max(np.abs(g.numpy() - ref)))
        assert err <= 1e-4 * float(np.max(np.abs(ref))) + 1e-7, f"{name}: max|d|={err:.3e}, max|ref|={np.abs(ref).max():.3e}"


def test_module_loop_matches_fused_reference(setup):
    """``kernels=off`` (module by module) and the fused formulation compute the
    same scan from the same Gumbel field."""
    _, _, _, wm, _ = setup
    rng = np.random.default_rng(1)
    emb = torch.tensor(rng.standard_normal((T, B, wm.encoder.output_dim)).astype(np.float32))
    act = torch.tensor(np.eye(2, dtype=np.float32)[rng.integers(0, 2, (T, B))])
    isf = torch.tensor((rng.random((T, B, 1)) < 0.3).astype(np.float32))
    isf[0] = 1.0
    g = torch.tensor(rng.gumbel(size=(T, B, 3, 4)).astype(np.float32))
    rssm = wm.rssm
    with torch.no_grad():
        fused = rssm.dynamic_scan(emb, act, isf, g)
        rssm.kernels = "off"
        try:
            loop = rssm.dynamic_scan(emb, act, isf, g)
        finally:
            rssm.kernels = "reference"
    for a, b in zip(fused, loop):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


def test_train_step_runs_and_counts(setup):
    _, _, _, wm, trainer = setup
    data = {k: torch.tensor(v) for k, v in _batch(np.random.default_rng(2)).items()}
    before = [p.detach().clone() for p in wm.parameters()]
    metrics = trainer.train_step(data, torch.Generator().manual_seed(0))
    assert metrics.shape == (15,) and bool(torch.isfinite(metrics).all())
    assert trainer.counter == 1
    assert any(not torch.equal(a, b) for a, b in zip(before, wm.parameters()))
