"""Replay buffers of the port: host numpy storage, optionally memory-mapped
(counterpart of sheeprl_tpu/data/buffers.py, numpy path).

Layout ``[buffer_size, n_envs, *]``; sampling uses a seeded
``np.random.Generator``, with the same draws as the JAX package's buffers for
the same seed. ``state_dict`` / ``load_state_dict`` use the JAX package's
checkpoint layout, so either package resumes the other's buffer. The native
``seq_gather`` of the JAX package is not ported.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Mapping, Optional, Sequence, Type

import numpy as np


class ReplayBuffer:
    """Circular dict-of-arrays buffer with layout ``[buffer_size, n_envs, *]``."""

    batch_axis: int = 1

    def __init__(
        self,
        buffer_size: int,
        n_envs: int = 1,
        memmap: bool = False,
        memmap_dir: Optional[str] = None,
        seed: Optional[int] = None,
    ):
        if buffer_size <= 0:
            raise ValueError(f"a replay buffer needs a positive capacity; received buffer_size={buffer_size}")
        if n_envs <= 0:
            raise ValueError(f"a replay buffer needs at least one env stream; received n_envs={n_envs}")
        if memmap and memmap_dir is None:
            raise ValueError("memmap=True needs a target directory: pass memmap_dir")
        self._buffer_size = buffer_size
        self._n_envs = n_envs
        self._memmap_dir = memmap_dir if memmap else None
        self._buf: Dict[str, np.ndarray] = {}
        self._pos = 0
        self._full = False
        self._rng = np.random.default_rng(seed)

    @property
    def empty(self) -> bool:
        return len(self._buf) == 0

    def seed(self, seed: Optional[int]) -> None:
        self._rng = np.random.default_rng(seed)

    def _allocate(self, key: str, sample_shape: Sequence[int], dtype) -> np.ndarray:
        shape = (self._buffer_size, self._n_envs, *sample_shape)
        if self._memmap_dir is not None:
            os.makedirs(self._memmap_dir, exist_ok=True)
            return np.lib.format.open_memmap(os.path.join(self._memmap_dir, f"{key}.npy"), mode="w+",
                                             dtype=dtype, shape=shape)
        return np.empty(shape, dtype=dtype)

    def add(self, data: Dict[str, np.ndarray]) -> None:
        """Append ``[T, n_envs, *]`` data, overwriting the oldest rows when full."""
        data_len = next(iter(data.values())).shape[0]
        next_pos = (self._pos + data_len) % self._buffer_size
        if next_pos <= self._pos or (data_len > self._buffer_size and not self._full):
            idxes = np.concatenate([np.arange(self._pos, self._buffer_size), np.arange(0, next_pos)])
        else:
            idxes = np.arange(self._pos, next_pos)
        if data_len > self._buffer_size:
            data = {k: v[-self._buffer_size - next_pos:] for k, v in data.items()}
        if self.empty:
            for k, v in data.items():
                self._buf[k] = self._allocate(k, v.shape[2:], v.dtype)
        for k, v in data.items():
            self._buf[k][idxes] = v
        if self._pos + data_len >= self._buffer_size:
            self._full = True
        self._pos = next_pos

    # ----- checkpoint support
    def state_dict(self) -> Dict[str, Any]:
        """``{"buffer": {key: array}, "pos", "full"}``; the arrays are views of the storage."""
        return {"buffer": {k: np.asarray(v) for k, v in self._buf.items()}, "pos": self._pos, "full": self._full}

    def load_state_dict(self, state: Mapping[str, Any]) -> "ReplayBuffer":
        buf = state["buffer"]
        for k, v in buf.items():
            v = np.asarray(v)
            if v.shape[:2] != (self._buffer_size, self._n_envs):
                raise ValueError(f"the checkpoint's buffer key {k!r} has shape {v.shape}; this buffer holds "
                                 f"[{self._buffer_size}, {self._n_envs}, *] (buffer.size / env.num_envs differ)")
            self._buf[k] = self._allocate(k, v.shape[2:], v.dtype)
            self._buf[k][...] = v
        self._pos = int(state["pos"])
        self._full = bool(state["full"])
        return self

    def _patch_truncated(self):
        """Set the last written step of every env to truncated (unless
        terminated); returns what :meth:`_unpatch_truncated` restores."""
        if self.empty or "truncated" not in self._buf:
            return None
        last = (self._pos - 1) % self._buffer_size
        original = np.array(self._buf["truncated"][last])
        self._buf["truncated"][last] = np.where(self._buf["terminated"][last], 0, 1)
        return last, original

    def _unpatch_truncated(self, undo) -> None:
        if undo is not None:
            last, original = undo
            self._buf["truncated"][last] = original


class SequentialReplayBuffer(ReplayBuffer):
    """Samples contiguous length-L windows: ``[n_samples, sequence_length, batch_size, *]``."""

    batch_axis: int = 2

    def sample(self, batch_size: int, n_samples: int = 1, sequence_length: int = 1) -> Dict[str, np.ndarray]:
        batch_dim = batch_size * n_samples
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError(f"sampling needs positive batch_size and n_samples; got {batch_size}, {n_samples}")
        if not self._full and self._pos == 0:
            raise ValueError("cannot sample from an empty buffer: add at least one transition first")
        if not self._full and self._pos - sequence_length + 1 < 1:
            raise ValueError(f"not enough history for sequence_length={sequence_length}: only {self._pos} steps stored")
        if self._full and sequence_length > self._buffer_size:
            raise ValueError(f"sequence_length={sequence_length} cannot exceed the buffer capacity ({self._buffer_size})")
        if self._full:
            first_range_end = self._pos - sequence_length + 1
            second_range_end = self._buffer_size if first_range_end >= 0 else self._buffer_size + first_range_end
            valid = np.concatenate(
                [np.arange(0, max(first_range_end, 0)), np.arange(self._pos, second_range_end)]
            ).astype(np.intp)
            start_idxes = valid[self._rng.integers(0, len(valid), size=(batch_dim,), dtype=np.intp)]
        else:
            start_idxes = self._rng.integers(0, self._pos - sequence_length + 1, size=(batch_dim,), dtype=np.intp)
        idxes = (start_idxes[:, None] + np.arange(sequence_length, dtype=np.intp)[None, :]) % self._buffer_size
        if self._n_envs == 1:
            pair_envs = np.zeros((batch_dim,), dtype=np.intp)
        else:
            pair_envs = self._rng.integers(0, self._n_envs, size=(batch_dim,), dtype=np.intp)
        flat_idx = np.ravel(idxes) * self._n_envs + np.repeat(pair_envs, sequence_length)
        out: Dict[str, np.ndarray] = {}
        for k, v in self._buf.items():
            flat_v = np.take(np.reshape(v, (-1, *v.shape[2:])), flat_idx, axis=0)
            out[k] = np.swapaxes(np.reshape(flat_v, (n_samples, batch_size, sequence_length) + flat_v.shape[1:]), 1, 2)
        return out


class EnvIndependentReplayBuffer:
    """One sub-buffer per env, so every env's stream stays contiguous; a batch
    is split multinomially across the sub-buffers."""

    def __init__(
        self,
        buffer_size: int,
        n_envs: int = 1,
        memmap: bool = False,
        memmap_dir: Optional[str] = None,
        buffer_cls: Type[ReplayBuffer] = SequentialReplayBuffer,
        seed: Optional[int] = None,
    ):
        if n_envs <= 0:
            raise ValueError(f"a replay buffer needs at least one env stream; received n_envs={n_envs}")
        self._buf = [
            buffer_cls(buffer_size, n_envs=1, memmap=memmap,
                       memmap_dir=os.path.join(memmap_dir, f"env_{i}") if memmap else None)
            for i in range(n_envs)
        ]
        self._n_envs = n_envs
        self._rng = np.random.default_rng(seed)
        self._concat_along_axis = buffer_cls.batch_axis

    def seed(self, seed: Optional[int]) -> None:
        self._rng = np.random.default_rng(seed)
        for i, b in enumerate(self._buf):
            b.seed(None if seed is None else seed + i + 1)

    def add(self, data: Dict[str, np.ndarray], indices: Optional[Sequence[int]] = None) -> None:
        if indices is None:
            indices = tuple(range(self._n_envs))
        elif len(indices) != next(iter(data.values())).shape[1]:
            raise ValueError(f"got {len(indices)} env indices for arrays of {next(iter(data.values())).shape[1]} envs")
        for col, env_idx in enumerate(indices):
            self._buf[env_idx].add({k: v[:, col:col + 1] for k, v in data.items()})

    def state_dict(self) -> Dict[str, Any]:
        return {"buffers": [b.state_dict() for b in self._buf]}

    def load_state_dict(self, state: Mapping[str, Any]) -> "EnvIndependentReplayBuffer":
        if "buffers" not in state:
            raise ValueError("the checkpoint's replay buffer was saved by the JAX package's device (HBM) "
                             "buffer, which the port does not read; resume with buffer.checkpoint=False")
        if len(state["buffers"]) != self._n_envs:
            raise ValueError(f"the checkpoint holds {len(state['buffers'])} env streams, this run has {self._n_envs}")
        for b, s in zip(self._buf, state["buffers"]):
            b.load_state_dict(s)
        return self

    def _patch_truncated(self) -> List[Any]:
        return [b._patch_truncated() for b in self._buf]

    def _unpatch_truncated(self, undo: Sequence[Any]) -> None:
        for b, u in zip(self._buf, undo):
            b._unpatch_truncated(u)

    def rng_states(self) -> List[Dict[str, Any]]:
        """The bit-generator states of the split and of every sub-buffer's sampler."""
        return [self._rng.bit_generator.state] + [b._rng.bit_generator.state for b in self._buf]

    def set_rng_states(self, states: Sequence[Mapping[str, Any]]) -> None:
        if len(states) != len(self._buf) + 1:
            raise ValueError(f"{len(states)} sampler states for a buffer of {len(self._buf)} env streams")
        for rng, st in zip([self._rng] + [b._rng for b in self._buf], states):
            rng.bit_generator.state = dict(st)

    def sample(self, batch_size: int, n_samples: int = 1, **kwargs: Any) -> Dict[str, np.ndarray]:
        bs_per_buf = np.bincount(self._rng.integers(0, self._n_envs, (batch_size,)))
        parts = [b.sample(batch_size=bs, n_samples=n_samples, **kwargs) for b, bs in zip(self._buf, bs_per_buf) if bs > 0]
        return {k: np.concatenate([p[k] for p in parts], axis=self._concat_along_axis) for k in parts[0]}
