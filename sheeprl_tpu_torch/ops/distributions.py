"""Distributions DreamerV3 uses (counterpart of sheeprl_tpu/ops/distributions.py).

Samplers take an explicit ``torch.Generator``; categorical samples are
Gumbel-argmax draws, as ``jax.random.categorical`` is.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

from sheeprl_tpu_torch.utils.utils import symexp, symlog

_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


def gumbel(shape, generator: torch.Generator, device, dtype=torch.float32) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(U))``, ``U`` uniform in ``[tiny, 1)``."""
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype).clamp_min(torch.finfo(dtype).tiny)
    return -torch.log(-torch.log(u))


def _reduce(x: torch.Tensor, dims: int) -> torch.Tensor:
    return x if dims == 0 else x.sum(dim=tuple(range(-dims, 0)))


class Normal:
    def __init__(self, loc: torch.Tensor, scale: torch.Tensor):
        self.loc, self.scale = loc, scale

    @property
    def mode(self) -> torch.Tensor:
        return self.loc

    mean = mode

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return -((value - self.loc) ** 2) / (2 * self.scale**2) - torch.log(self.scale) - _HALF_LOG_2PI

    def entropy(self) -> torch.Tensor:
        return 0.5 + _HALF_LOG_2PI + torch.log(self.scale)

    def rsample(self, generator: torch.Generator) -> torch.Tensor:
        shape = torch.broadcast_shapes(self.loc.shape, self.scale.shape)
        eps = torch.randn(shape, generator=generator, device=self.loc.device, dtype=self.loc.dtype)
        return self.loc + self.scale * eps


class TanhNormal:
    """Squashed diagonal gaussian."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor):
        self.base = Normal(loc, scale)

    @property
    def mode(self) -> torch.Tensor:
        return torch.tanh(self.base.loc)

    mean = mode

    def rsample(self, generator: torch.Generator) -> torch.Tensor:
        return torch.tanh(self.base.rsample(generator))

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        pre = torch.atanh(value.clamp(-1 + 1e-6, 1 - 1e-6))
        return self.base.log_prob(pre) - 2.0 * (math.log(2.0) - pre - F.softplus(-2.0 * pre))

    def entropy(self) -> torch.Tensor:
        raise NotImplementedError


class Independent:
    """Sum the last ``reinterpreted_batch_ndims`` dims of log_prob/entropy."""

    def __init__(self, base, reinterpreted_batch_ndims: int = 1):
        self.base = base
        self.ndims = reinterpreted_batch_ndims

    @property
    def mode(self) -> torch.Tensor:
        return self.base.mode

    @property
    def mean(self) -> torch.Tensor:
        return self.base.mean

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return _reduce(self.base.log_prob(value), self.ndims)

    def entropy(self) -> torch.Tensor:
        return _reduce(self.base.entropy(), self.ndims)

    def rsample(self, generator: torch.Generator) -> torch.Tensor:
        return self.base.rsample(generator)


class OneHotCategorical:
    def __init__(self, logits: torch.Tensor):
        self.logits = logits - torch.logsumexp(logits, dim=-1, keepdim=True)

    @property
    def probs(self) -> torch.Tensor:
        return torch.softmax(self.logits, dim=-1)

    @property
    def mode(self) -> torch.Tensor:
        return F.one_hot(self.logits.argmax(dim=-1), self.logits.shape[-1]).to(self.logits.dtype)

    @property
    def mean(self) -> torch.Tensor:
        return self.probs

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return (value * self.logits).sum(dim=-1)

    def entropy(self) -> torch.Tensor:
        return -(self.probs * self.logits).sum(dim=-1)

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        g = gumbel(self.logits.shape, generator, self.logits.device)
        idx = (self.logits.detach().float() + g).argmax(dim=-1)
        return F.one_hot(idx, self.logits.shape[-1]).to(self.logits.dtype)

    def rsample(self, generator: torch.Generator) -> torch.Tensor:
        return self.sample(generator)


class OneHotCategoricalStraightThrough(OneHotCategorical):
    """One-hot sample whose gradient is the softmax's (straight-through)."""

    def rsample(self, generator: torch.Generator) -> torch.Tensor:
        probs = self.probs
        return self.sample(generator) + probs - probs.detach()


class BernoulliSafeMode:
    def __init__(self, logits: torch.Tensor):
        self.logits = logits

    @property
    def probs(self) -> torch.Tensor:
        return torch.sigmoid(self.logits)

    @property
    def mean(self) -> torch.Tensor:
        return self.probs

    @property
    def mode(self) -> torch.Tensor:
        return (self.probs > 0.5).to(self.logits.dtype)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        x = self.logits
        return -(x.clamp_min(0) - x * value + torch.log1p(torch.exp(-x.abs())))


class SymlogDistribution:
    """symlog-MSE log-prob for vector decoder heads."""

    def __init__(self, mode: torch.Tensor, dims: int, dist: str = "mse", agg: str = "sum", tol: float = 1e-8):
        self._mode, self._dims, self._dist, self._agg, self._tol = mode, dims, dist, agg, tol

    @property
    def mode(self) -> torch.Tensor:
        return symexp(self._mode)

    mean = mode

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        if self._mode.shape != value.shape:
            raise ValueError(f"shape mismatch {tuple(self._mode.shape)} vs {tuple(value.shape)}")
        if self._dist == "mse":
            distance = (self._mode - symlog(value)) ** 2
        elif self._dist == "abs":
            distance = (self._mode - symlog(value)).abs()
        else:
            raise NotImplementedError(self._dist)
        distance = torch.where(distance < self._tol, torch.zeros_like(distance), distance)
        axes = tuple(range(-self._dims, 0))
        return -(distance.mean(axes) if self._agg == "mean" else distance.sum(axes))


class MSEDistribution:
    """MSE log-prob for image decoder heads."""

    def __init__(self, mode: torch.Tensor, dims: int, agg: str = "sum"):
        self._mode, self._dims, self._agg = mode, dims, agg

    @property
    def mode(self) -> torch.Tensor:
        return self._mode

    mean = mode

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        if self._mode.shape != value.shape:
            raise ValueError(f"shape mismatch {tuple(self._mode.shape)} vs {tuple(value.shape)}")
        distance = (self._mode - value) ** 2
        axes = tuple(range(-self._dims, 0))
        return -(distance.mean(axes) if self._agg == "mean" else distance.sum(axes))


class TwoHotEncodingDistribution:
    """Categorical over symlog-spaced bins with two-hot targets (reward/critic heads)."""

    def __init__(
        self,
        logits: torch.Tensor,
        dims: int = 0,
        low: float = -20.0,
        high: float = 20.0,
        transfwd: Callable[[torch.Tensor], torch.Tensor] = symlog,
        transbwd: Callable[[torch.Tensor], torch.Tensor] = symexp,
    ):
        self.logits = logits
        self.probs = torch.softmax(logits, dim=-1)
        self.dims = tuple(-x for x in range(1, dims + 1)) or (-1,)
        self.bins = torch.linspace(low, high, logits.shape[-1], device=logits.device)
        self.transfwd, self.transbwd = transfwd, transbwd

    @property
    def mean(self) -> torch.Tensor:
        return self.transbwd((self.probs * self.bins).sum(dim=self.dims, keepdim=True))

    mode = mean

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        x = self.transfwd(x)
        nbins = self.bins.shape[0]
        below = (self.bins <= x).to(torch.int64).sum(dim=-1, keepdim=True) - 1
        above = (below + 1).clamp(0, nbins - 1)
        below = below.clamp(0, nbins - 1)
        equal = below == above
        one = torch.ones_like(x)
        dist_below = torch.where(equal, one, (self.bins[below] - x).abs())
        dist_above = torch.where(equal, one, (self.bins[above] - x).abs())
        total = dist_below + dist_above
        w_below, w_above = dist_above / total, dist_below / total
        target = (F.one_hot(below, nbins) * w_below[..., None] + F.one_hot(above, nbins) * w_above[..., None])[..., 0, :]
        log_pred = self.logits - torch.logsumexp(self.logits, dim=-1, keepdim=True)
        return (target * log_pred).sum(dim=self.dims)
