"""Model building blocks of the port (counterpart of sheeprl_tpu/models/models.py).

Tensors keep PyTorch's layouts (NCHW images, ``Linear`` weights ``[out, in]``);
``compat/flax_params.py`` converts the JAX package's parameters into them.
Normalizations compute in float32 and return the input's dtype, so under
``bf16-mixed`` autocast the LayerNorm statistics stay float32.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

_ACTIVATIONS = {
    "relu": F.relu, "tanh": torch.tanh, "silu": F.silu, "swish": F.silu, "elu": F.elu, "gelu": F.gelu,
    "sigmoid": torch.sigmoid, "identity": lambda x: x, "none": lambda x: x,
}


def activation_name(name: Optional[str]) -> str:
    key = "none" if name is None else str(name).rsplit(".", 1)[-1].lower()
    if key not in _ACTIVATIONS:
        raise ValueError(f"Unknown activation '{name}'. Available: {sorted(_ACTIVATIONS)}")
    return key


def activate(name: str, x: torch.Tensor) -> torch.Tensor:
    return _ACTIVATIONS[name](x)


def _per_layer(spec, n: int) -> list:
    if isinstance(spec, (list, tuple)):
        if len(spec) != n:
            raise ValueError(f"Per-layer spec length {len(spec)} != number of layers {n}")
        return list(spec)
    return [spec] * n


class LayerNorm(nn.Module):
    """LayerNorm over the last dim computed in float32, returning the input dtype."""

    def __init__(self, normalized_shape: int, eps: float = 1e-5):
        super().__init__()
        self.eps = float(eps)
        self.weight = nn.Parameter(torch.ones(normalized_shape))
        self.bias = nn.Parameter(torch.zeros(normalized_shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.autocast(device_type=x.device.type, enabled=False):
            y = F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias, self.eps)
        return y.to(x.dtype)


class LayerNormChannelLast(LayerNorm):
    """LayerNorm over the channels of an NCHW tensor."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 4:
            raise ValueError(f"Input tensor must be 4D (NCHW), received {x.dim()}D instead: {tuple(x.shape)}")
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class MLP(nn.Module):
    """Hidden layers ``Linear -> [LayerNorm] -> activation``, then an optional
    ``Linear`` head. ``use_bias`` applies to the hidden layers; the head has one."""

    def __init__(
        self,
        input_dims: int,
        output_dim: Optional[int] = None,
        hidden_sizes: Sequence[int] = (),
        activation: Optional[str] = "relu",
        layer_norm: bool = False,
        norm_args: Optional[Dict[str, Any]] = None,
        use_bias: bool = True,
    ):
        super().__init__()
        if len(hidden_sizes) == 0 and output_dim is None:
            raise ValueError("The number of layers should be at least 1.")
        self.activation = activation_name(activation)
        sizes = [int(input_dims), *[int(h) for h in hidden_sizes]]
        self.linears = nn.ModuleList(nn.Linear(i, o, bias=use_bias) for i, o in zip(sizes[:-1], sizes[1:]))
        eps = float((norm_args or {}).get("eps", 1e-5))
        self.norms = nn.ModuleList(LayerNorm(o, eps) if layer_norm else nn.Identity() for o in sizes[1:])
        self.head = nn.Linear(sizes[-1], int(output_dim)) if output_dim is not None else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for linear, norm in zip(self.linears, self.norms):
            x = activate(self.activation, norm(linear(x)))
        return self.head(x) if self.head is not None else x


class CNN(nn.Module):
    """Conv stack ``Conv2d -> [LayerNormChannelLast] -> activation`` (NCHW)."""

    def __init__(
        self,
        input_channels: int,
        hidden_channels: Sequence[int],
        layer_args: Dict[str, Any],
        activation: str = "relu",
        layer_norm: bool = False,
        norm_args: Optional[Dict[str, Any]] = None,
    ):
        super().__init__()
        self.activation = activation_name(activation)
        chans = [int(input_channels), *[int(c) for c in hidden_channels]]
        k, s, p = layer_args.get("kernel_size", 3), layer_args.get("stride", 1), layer_args.get("padding", 0)
        bias = layer_args.get("bias", True)
        self.convs = nn.ModuleList(nn.Conv2d(i, o, k, s, p, bias=bias) for i, o in zip(chans[:-1], chans[1:]))
        eps = float((norm_args or {}).get("eps", 1e-5))
        self.norms = nn.ModuleList(LayerNormChannelLast(o, eps) if layer_norm else nn.Identity() for o in chans[1:])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, norm in zip(self.convs, self.norms):
            x = activate(self.activation, norm(conv(x)))
        return x


class DeCNN(nn.Module):
    """Transposed-conv stack with per-layer args, activation and norm (NCHW)."""

    def __init__(
        self,
        input_channels: int,
        hidden_channels: Sequence[int],
        layer_args: Sequence[Dict[str, Any]],
        activation: Sequence[Optional[str]],
        layer_norm: Sequence[bool],
        norm_args: Optional[Dict[str, Any]] = None,
    ):
        super().__init__()
        n = len(hidden_channels)
        chans = [int(input_channels), *[int(c) for c in hidden_channels]]
        eps = float((norm_args or {}).get("eps", 1e-5))
        self.activations = [activation_name(a) for a in _per_layer(activation, n)]
        self.deconvs = nn.ModuleList()
        for i, args in enumerate(_per_layer(layer_args, n)):
            self.deconvs.append(nn.ConvTranspose2d(
                chans[i], chans[i + 1], args.get("kernel_size", 3), args.get("stride", 1), args.get("padding", 0),
                output_padding=args.get("output_padding", 0), bias=args.get("bias", True)))
        self.norms = nn.ModuleList(
            LayerNormChannelLast(o, eps) if ln else nn.Identity() for o, ln in zip(chans[1:], _per_layer(layer_norm, n))
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for deconv, norm, act in zip(self.deconvs, self.norms, self.activations):
            x = activate(act, norm(deconv(x)))
        return x


class LayerNormGRUCell(nn.Module):
    """Hafner GRU: one fused ``Linear`` over ``[h, x]`` -> float32 LayerNorm ->
    (reset, candidate, update); the update gate is ``sigmoid(u - 1)``."""

    def __init__(self, input_size: int, hidden_size: int, bias: bool = True, layer_norm: bool = False,
                 layer_norm_eps: float = 1e-5):
        super().__init__()
        self.hidden_size = int(hidden_size)
        self.eps = float(layer_norm_eps)
        self.weight = nn.Parameter(torch.empty(3 * hidden_size, hidden_size + input_size))
        self.bias = nn.Parameter(torch.zeros(3 * hidden_size)) if bias else None
        self.ln_weight = nn.Parameter(torch.ones(3 * hidden_size)) if layer_norm else None
        self.ln_bias = nn.Parameter(torch.zeros(3 * hidden_size)) if layer_norm else None
        nn.init.xavier_uniform_(self.weight)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        fused = F.linear(torch.cat([h, x.to(h.dtype)], dim=-1), self.weight, self.bias)
        h = h.to(fused.dtype)
        if self.ln_weight is not None:
            with torch.autocast(device_type=x.device.type, enabled=False):
                y = F.layer_norm(fused.float(), self.ln_weight.shape, self.ln_weight, self.ln_bias, self.eps)
            fused = y.to(fused.dtype)
        reset, cand, update = torch.chunk(fused, 3, dim=-1)
        reset = torch.sigmoid(reset)
        cand = torch.tanh(reset * cand)
        update = torch.sigmoid(update - 1)
        return update * cand + (1 - update) * h
