"""Behaviour learning of the port against the JAX package's train step, on the
CPU at the ``TINY`` config of ``tests/test_torch_dreamer_v3.py``.

Two gradient steps from the same converted parameters and batches: the JAX
side runs ``make_train_fn`` (``sheeprl_tpu/algos/dreamer_v3/dreamer_v3.py``,
its imagination, actor, critic, Moments and target-critic EMA), the port runs
``DV3Trainer.train_step``, fed the Gumbel fields the JAX step draws from its
keys: the posterior field of the world model, then the first action's noise,
then for each of the H imagined steps the prior's field and the action's noise.
After each step: every metric (the world-model, policy and value losses, the
Moments state, the gradient norms) rtol 1e-4, the Moments state itself and the
target critic after its EMA rtol 1e-4 / atol 1e-6 (float32). Every parameter
is first moved off its Hafner init, whose zero reward and critic heads leave
no advantage to learn from.
"""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import torch

from sheeprl_tpu.algos.dreamer_v3 import agent as jagent
from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import make_train_fn
from sheeprl_tpu.algos.dreamer_v3.utils import init_moments
from sheeprl_tpu.config import compose as jcompose
from sheeprl_tpu.core.runtime import Runtime as JRuntime
from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as tdv3
from sheeprl_tpu_torch.algos.dreamer_v3 import agent as tagent
from sheeprl_tpu_torch.compat import flax_params
from sheeprl_tpu_torch.config import compose as tcompose
from sheeprl_tpu_torch.core.runtime import Runtime
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.ops import distributions as tdist
from tests.test_torch_agent_features import _Noise
from tests.test_torch_dreamer_v3 import TINY, B, T, _batch

STEPS = 2


def _step_noise(key, horizon, s, d, n_actions):
    """The Gumbel fields one JAX gradient step draws, in the port's order."""
    k_wm, k_img0, k_img, _ = jax.random.split(jax.random.split(key, 1)[0], 4)
    fields = [jax.random.gumbel(jax.random.fold_in(k_wm, 1), (T, B, s, d), jnp.float32),
              jax.random.gumbel(jax.random.split(k_img0, 1)[0], (T * B, n_actions), jnp.float32)]
    for k in jax.random.split(k_img, horizon):
        k_img_step, k_act_step = jax.random.split(k)
        fields.append(jax.random.gumbel(k_img_step, (T * B, s, d), jnp.float32))
        fields.append(jax.random.gumbel(jax.random.split(k_act_step, 1)[0], (T * B, n_actions), jnp.float32))
    return fields


def test_train_steps_match_jax(monkeypatch):
    jcfg, tcfg = jcompose("config", TINY), tcompose(TINY + ["fabric.accelerator=cpu"])
    jobs = gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, (3, 16, 16), np.uint8),
                            "state": gym.spaces.Box(-20, 20, (10,), np.float32)})
    tobs = spaces.Dict({"rgb": spaces.Box(0, 255, (3, 16, 16), np.uint8), "state": spaces.Box(-20, 20, (10,))})
    jruntime = JRuntime(accelerator="cpu", devices=1, precision="32-true")
    modules, params, _ = jagent.build_agent(jruntime, (2,), False, jcfg, jobs)
    runtime = Runtime(accelerator="cpu", precision="32-true")
    wm, actor, critic, target, _ = tagent.build_agent(runtime, (2,), False, tcfg, tobs)
    # Hafner init zeroes the reward and critic heads, so returns, values and
    # advantages start at 0 and the policy gradient is the entropy's alone, at
    # its stationary point: move every parameter off its init
    noise_rng = np.random.default_rng(3)
    host = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * noise_rng.standard_normal(np.shape(x)).astype(np.float32),
        jax.device_get(params))
    params = jax.tree_util.tree_map(jnp.asarray, host)
    wm.load_state_dict(flax_params.world_model_state_dict(host["world_model"]), strict=True)
    actor.load_state_dict(flax_params.to_state_dict(host["actor"]), strict=True)
    critic.load_state_dict(flax_params.to_state_dict(host["critic"]), strict=True)
    target.load_state_dict(flax_params.to_state_dict(host["target_critic"]), strict=True)
    trainer = tdv3.DV3Trainer(wm, actor, critic, target, tcfg, runtime, False, [2])

    init_opt, train_fn = make_train_fn(modules, jcfg, jruntime, False, (2,))
    opt_states, moments, counter = init_opt(params), init_moments(), jnp.int32(0)
    rng = np.random.default_rng(4)
    wm_cfg = jcfg.algo.world_model
    horizon, s, d = int(jcfg.algo.horizon), int(wm_cfg.stochastic_size), int(wm_cfg.discrete_size)
    for step in range(STEPS):
        data = _batch(rng)
        key = jax.random.PRNGKey(100 + step)
        params, opt_states, moments, counter, _, j_metrics = train_fn(
            params, opt_states, moments, counter, {k: jnp.asarray(v[None]) for k, v in data.items()}, key)

        noise = _Noise(_step_noise(key, horizon, s, d, 2))
        monkeypatch.setattr(tdv3, "gumbel", noise)
        monkeypatch.setattr(tdist, "gumbel", noise)
        t_metrics = trainer.train_step({k: torch.tensor(v) for k, v in data.items()}, torch.Generator())
        assert not noise.fields, "the port drew another number of Gumbel fields than the JAX step"

        for name, got in zip(tdv3.METRIC_NAMES, t_metrics.tolist()):
            np.testing.assert_allclose(got, float(j_metrics[name]), rtol=1e-4, err_msg=f"step {step}: {name}")
        np.testing.assert_allclose(float(trainer.moments.low), float(moments.low), rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(float(trainer.moments.high), float(moments.high), rtol=1e-4, atol=1e-7)
        ref_target = flax_params.to_state_dict(jax.device_get(params["target_critic"]))
        got_target = target.state_dict()
        assert set(ref_target) == set(got_target)
        for name, ref in ref_target.items():
            np.testing.assert_allclose(got_target[name].numpy(), ref.numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {step}: target critic {name}")
    assert trainer.counter == int(counter) == STEPS
