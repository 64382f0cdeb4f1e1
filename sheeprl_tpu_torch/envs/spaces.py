"""Minimal observation/action spaces and env base class for the port.

The card's machine has no gymnasium; these keep the part of its interface the
port uses: ``Box``, ``Discrete``, ``MultiDiscrete`` and ``Dict`` with
``shape``, ``dtype``, ``seed`` and ``sample``, and ``Env`` with
``reset``/``step``/``close``.
"""

from __future__ import annotations

from typing import Dict as TDict, Optional, Sequence, Tuple

import numpy as np


class Space:
    shape: Tuple[int, ...] = ()
    dtype = None

    def __init__(self, seed: Optional[int] = None):
        self.np_random = np.random.default_rng(seed)

    def seed(self, seed: Optional[int] = None) -> None:
        self.np_random = np.random.default_rng(seed)


class Box(Space):
    def __init__(self, low, high, shape: Optional[Sequence[int]] = None, dtype=np.float32, seed: Optional[int] = None):
        super().__init__(seed)
        self.dtype = np.dtype(dtype)
        self.shape = tuple(shape) if shape is not None else np.shape(low)
        self.low = np.broadcast_to(np.asarray(low, dtype=self.dtype), self.shape)
        self.high = np.broadcast_to(np.asarray(high, dtype=self.dtype), self.shape)

    def sample(self) -> np.ndarray:
        low = np.where(np.isfinite(self.low), self.low, -1.0)
        high = np.where(np.isfinite(self.high), self.high, 1.0)
        return self.np_random.uniform(low, high, size=self.shape).astype(self.dtype)


class Discrete(Space):
    def __init__(self, n: int, seed: Optional[int] = None):
        super().__init__(seed)
        self.n = int(n)
        self.dtype = np.dtype(np.int64)

    def sample(self) -> np.int64:
        return np.int64(self.np_random.integers(self.n))


class MultiDiscrete(Space):
    def __init__(self, nvec: Sequence[int], seed: Optional[int] = None):
        super().__init__(seed)
        self.nvec = np.asarray(nvec, dtype=np.int64)
        self.shape = self.nvec.shape
        self.dtype = np.dtype(np.int64)

    def sample(self) -> np.ndarray:
        return self.np_random.integers(self.nvec).astype(np.int64)


class Dict(Space):
    def __init__(self, spaces: TDict[str, Space], seed: Optional[int] = None):
        super().__init__(seed)
        self.spaces = dict(spaces)

    def __getitem__(self, key: str) -> Space:
        return self.spaces[key]

    def keys(self):
        return self.spaces.keys()

    def items(self):
        return self.spaces.items()

    def seed(self, seed: Optional[int] = None) -> None:
        super().seed(seed)
        for i, space in enumerate(self.spaces.values()):
            space.seed(None if seed is None else seed + i)


def batch_space(space: Space, n: int) -> Space:
    """The space of ``n`` stacked samples (what a vector env's ``action_space`` is)."""
    if isinstance(space, Discrete):
        return MultiDiscrete([space.n] * n)
    if isinstance(space, MultiDiscrete):
        return MultiDiscrete(np.tile(space.nvec, (n, 1)))
    if isinstance(space, Box):
        return Box(np.broadcast_to(space.low, (n, *space.shape)), np.broadcast_to(space.high, (n, *space.shape)),
                   dtype=space.dtype)
    raise TypeError(f"cannot batch {type(space).__name__}")


class Env:
    observation_space: Space
    action_space: Space

    def reset(self, seed: Optional[int] = None, options=None):
        raise NotImplementedError

    def step(self, action):
        raise NotImplementedError

    def close(self) -> None:
        pass
