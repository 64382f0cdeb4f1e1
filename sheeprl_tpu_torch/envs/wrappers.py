"""Env wrappers the port's ``make_env`` uses for the dummy envs (counterparts
in sheeprl_tpu/envs/wrappers.py and gymnasium.wrappers)."""

from __future__ import annotations

import copy
from typing import Sequence

import numpy as np

from sheeprl_tpu_torch.envs import spaces


class Wrapper(spaces.Env):
    def __init__(self, env: spaces.Env):
        self.env = env
        self.observation_space = env.observation_space
        self.action_space = env.action_space

    def reset(self, seed=None, options=None):
        return self.env.reset(seed=seed, options=options)

    def step(self, action):
        return self.env.step(action)

    def close(self) -> None:
        self.env.close()


class ImageTransformWrapper(Wrapper):
    """Pixel observations as uint8 ``[C, H, W]`` with ``H = W = screen_size``.

    Channel-last images are transposed and a single channel is repeated to
    three. Resizing and RGB -> gray conversion (cv2 in the JAX package) are not
    ported: an image that needs them raises.
    """

    def __init__(self, env: spaces.Env, cnn_keys: Sequence[str], screen_size: int, grayscale: bool):
        super().__init__(env)
        self._keys = list(cnn_keys)
        self._size = int(screen_size)
        self._gray = bool(grayscale)
        self.observation_space = copy.deepcopy(env.observation_space)
        channels = 1 if self._gray else 3
        for k in self._keys:
            self.observation_space.spaces[k] = spaces.Box(0, 255, (channels, self._size, self._size), np.uint8)

    def _transform(self, img: np.ndarray) -> np.ndarray:
        if img.ndim == 2:
            img = img[None]
        if img.shape[0] not in (1, 3):
            img = np.transpose(img, (2, 0, 1))
        if img.shape[1:] != (self._size, self._size):
            raise NotImplementedError(
                f"image of size {img.shape[1:]} needs resizing to {self._size}: not ported (cv2); "
                "use env.screen_size equal to the env's own image size"
            )
        if self._gray and img.shape[0] == 3:
            raise NotImplementedError("RGB -> gray conversion is not ported (cv2)")
        if not self._gray and img.shape[0] == 1:
            img = np.repeat(img, 3, axis=0)
        return np.ascontiguousarray(img.astype(np.uint8))

    def _apply(self, obs):
        for k in self._keys:
            obs[k] = self._transform(np.asarray(obs[k]))
        return obs

    def reset(self, seed=None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        return self._apply(obs), info

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        return self._apply(obs), reward, terminated, truncated, info


class ActionRepeat(Wrapper):
    """Repeat the action ``amount`` times, summing rewards."""

    def __init__(self, env: spaces.Env, amount: int = 1):
        super().__init__(env)
        if amount <= 0:
            raise ValueError("`amount` should be a positive integer")
        self._amount = int(amount)

    def step(self, action):
        total = 0.0
        obs, terminated, truncated, info = None, False, False, {}
        for _ in range(self._amount):
            obs, reward, terminated, truncated, info = self.env.step(action)
            total += float(reward)
            if terminated or truncated:
                break
        return obs, total, terminated, truncated, info


class TimeLimit(Wrapper):
    """Truncate an episode after ``max_episode_steps`` steps."""

    def __init__(self, env: spaces.Env, max_episode_steps: int):
        super().__init__(env)
        self._max = int(max_episode_steps)
        self._elapsed = 0

    def reset(self, seed=None, options=None):
        self._elapsed = 0
        return self.env.reset(seed=seed, options=options)

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self._elapsed += 1
        return obs, reward, terminated, truncated or self._elapsed >= self._max, info


class RecordEpisodeStatistics(Wrapper):
    """Adds ``info["episode"] = {"r": return, "l": length}`` when an episode ends."""

    def __init__(self, env: spaces.Env):
        super().__init__(env)
        self._return, self._length = 0.0, 0

    def reset(self, seed=None, options=None):
        self._return, self._length = 0.0, 0
        return self.env.reset(seed=seed, options=options)

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self._return += float(reward)
        self._length += 1
        if terminated or truncated:
            info = dict(info, episode={"r": self._return, "l": self._length})
        return obs, reward, terminated, truncated, info
