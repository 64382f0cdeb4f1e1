"""Deterministic dummy environments (copy of sheeprl_tpu/envs/dummy.py on the
port's own spaces): dict observations with a uint8 CHW ``rgb`` image and a
``state`` vector, both encoding the step counter."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from sheeprl_tpu_torch.envs import spaces


class _DummyBase(spaces.Env):
    def __init__(
        self,
        image_size: Tuple[int, int, int] = (3, 64, 64),
        n_steps: int = 128,
        vector_shape: Tuple[int] = (10,),
        dict_obs_space: bool = True,
    ):
        self._dict_obs_space = dict_obs_space
        if dict_obs_space:
            self.observation_space = spaces.Dict(
                {
                    "rgb": spaces.Box(0, 255, shape=image_size, dtype=np.uint8),
                    "state": spaces.Box(-20, 20, shape=vector_shape, dtype=np.float32),
                }
            )
        else:
            self.observation_space = spaces.Box(-20, 20, shape=vector_shape, dtype=np.float32)
        self._step_count = 0
        self._n_steps = n_steps

    def get_obs(self):
        if self._dict_obs_space:
            return {
                "rgb": np.full(self.observation_space["rgb"].shape, self._step_count % 256, dtype=np.uint8),
                "state": np.full(self.observation_space["state"].shape, self._step_count, dtype=np.uint8),
            }
        return np.full(self.observation_space.shape, self._step_count, dtype=np.uint8)

    def step(self, action):
        terminated = self._step_count == self._n_steps
        self._step_count += 1
        return self.get_obs(), 0.0, terminated, False, {}

    def reset(self, seed=None, options=None):
        self._step_count = 0
        return self.get_obs(), {}


class ContinuousDummyEnv(_DummyBase):
    def __init__(self, image_size=(3, 64, 64), n_steps=128, vector_shape=(10,), action_dim=2, dict_obs_space=True):
        self.action_space = spaces.Box(-np.inf, np.inf, shape=(action_dim,))
        super().__init__(image_size, n_steps, vector_shape, dict_obs_space)


class DiscreteDummyEnv(_DummyBase):
    def __init__(self, image_size=(3, 64, 64), n_steps=4, vector_shape=(10,), action_dim=2, dict_obs_space=True):
        self.action_space = spaces.Discrete(action_dim)
        super().__init__(image_size, n_steps, vector_shape, dict_obs_space)


class MultiDiscreteDummyEnv(_DummyBase):
    def __init__(
        self,
        image_size=(3, 64, 64),
        n_steps: int = 128,
        vector_shape=(10,),
        action_dims: List[int] = [2, 2],
        dict_obs_space: bool = True,
    ):
        self.action_space = spaces.MultiDiscrete(action_dims)
        super().__init__(image_size, n_steps, vector_shape, dict_obs_space)
