"""Carry the JAX package's DreamerV3 parameters into the port's modules.

Input: the flax parameter trees as numpy arrays (``jax.device_get``), as
``sheeprl_tpu.algos.dreamer_v3.agent.build_agent`` returns them. Output:
``state_dict``s of the port's ``WorldModel``, ``Actor`` and critic:

- Dense ``kernel [in, out]`` -> Linear ``weight [out, in]``;
- Conv ``kernel [kh, kw, in, out]`` (HWIO) -> Conv2d ``weight [out, in, kh, kw]``;
- ConvTranspose ``kernel [kh, kw, out, in]`` (``transpose_kernel=True``) ->
  ConvTranspose2d ``weight [in, out, kh, kw]``;
- LayerNorm ``scale``/``bias`` -> ``weight``/``bias``;
- the GRU's fused ``[h, x]`` kernel -> ``gru.weight`` (same column order);
- ``initial_recurrent_state`` as is.

Images cross the boundary in NCHW on both sides (the flax modules transpose to
NHWC internally), so no activation layout changes.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _t(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _params(tree: Mapping[str, Any]) -> Mapping[str, Any]:
    return tree["params"] if "params" in tree else tree


def _dense(tree, prefix: str, out: StateDict) -> None:
    out[f"{prefix}.weight"] = _t(tree["kernel"]).T.contiguous()
    if "bias" in tree:
        out[f"{prefix}.bias"] = _t(tree["bias"])


def _layer_norm(tree, prefix: str, out: StateDict) -> None:
    inner = tree["LayerNorm_0"]
    out[f"{prefix}.weight"] = _t(inner["scale"])
    out[f"{prefix}.bias"] = _t(inner["bias"])


def _mlp(tree, prefix: str, out: StateDict, n_hidden: int, head: bool = False) -> None:
    """flax ``MLP``: ``Dense_i`` (+ ``LayerNorm_i``) per hidden layer, ``Dense_n`` head."""
    for i in range(n_hidden):
        _dense(tree[f"Dense_{i}"], f"{prefix}.linears.{i}", out)
        if f"LayerNorm_{i}" in tree:
            _layer_norm(tree[f"LayerNorm_{i}"], f"{prefix}.norms.{i}", out)
    if head:
        _dense(tree[f"Dense_{n_hidden}"], f"{prefix}.head", out)


def _n_dense(tree) -> int:
    return sum(1 for k in tree if k.startswith("Dense_"))


def _conv(tree, prefix: str, out: StateDict) -> None:
    out[f"{prefix}.weight"] = _t(tree["kernel"]).permute(3, 2, 0, 1).contiguous()
    if "bias" in tree:
        out[f"{prefix}.bias"] = _t(tree["bias"])


def mlp_with_head(tree, prefix: str = "") -> StateDict:
    tree = _params(tree)
    out: StateDict = {}
    p = f"{prefix}." if prefix else ""
    if "MLP_0" in tree:
        _mlp(tree["MLP_0"], f"{p}mlp", out, _n_dense(tree["MLP_0"]))
    _dense(tree["head"], f"{p}head", out)
    return out


def recurrent_model(tree, prefix: str = "") -> StateDict:
    tree = _params(tree)
    out: StateDict = {}
    p = f"{prefix}." if prefix else ""
    _mlp(tree["MLP_0"], f"{p}mlp", out, 1)
    gru = tree["LayerNormGRUCell_0"]
    out[f"{p}gru.weight"] = _t(gru["kernel"]).T.contiguous()
    if "bias" in gru:
        out[f"{p}gru.bias"] = _t(gru["bias"])
    if "ln_scale" in gru:
        out[f"{p}gru.ln_weight"] = _t(gru["ln_scale"])
        out[f"{p}gru.ln_bias"] = _t(gru["ln_bias"])
    return out


def encoder(tree, prefix: str = "encoder") -> StateDict:
    tree = _params(tree)
    out: StateDict = {}
    if "cnn_encoder" in tree:
        cnn = tree["cnn_encoder"]["CNN_0"]
        for i in range(sum(1 for k in cnn if k.startswith("Conv_"))):
            _conv(cnn[f"Conv_{i}"], f"{prefix}.cnn_encoder.cnn.convs.{i}", out)
            if f"LayerNorm_{i}" in cnn:
                _layer_norm(cnn[f"LayerNorm_{i}"], f"{prefix}.cnn_encoder.cnn.norms.{i}", out)
    if "mlp_encoder" in tree:
        mlp = tree["mlp_encoder"]["MLP_0"]
        _mlp(mlp, f"{prefix}.mlp_encoder.mlp", out, _n_dense(mlp))
    return out


def observation_model(tree, prefix: str = "observation_model") -> StateDict:
    tree = _params(tree)
    out: StateDict = {}
    if "cnn_decoder" in tree:
        dec = tree["cnn_decoder"]
        _dense(dec["Dense_0"], f"{prefix}.cnn_decoder.linear", out)
        deconv = dec["DeCNN_0"]
        for i in range(sum(1 for k in deconv if k.startswith("ConvTranspose_"))):
            _conv(deconv[f"ConvTranspose_{i}"], f"{prefix}.cnn_decoder.deconv.deconvs.{i}", out)
            if f"LayerNorm_{i}" in deconv:
                _layer_norm(deconv[f"LayerNorm_{i}"], f"{prefix}.cnn_decoder.deconv.norms.{i}", out)
    if "mlp_decoder" in tree:
        dec = tree["mlp_decoder"]
        _mlp(dec["MLP_0"], f"{prefix}.mlp_decoder.mlp", out, _n_dense(dec["MLP_0"]))
        for k in dec:
            if k.startswith("head_"):
                _dense(dec[k], f"{prefix}.mlp_decoder.heads.{k[len('head_'):]}", out)
    return out


def world_model_state_dict(wm_params: Mapping[str, Any]) -> StateDict:
    """The JAX world-model param dict -> the port's ``WorldModel.state_dict()``."""
    out: StateDict = {}
    out.update(encoder(wm_params["encoder"]))
    out.update(recurrent_model(wm_params["recurrent_model"], "rssm.recurrent_model"))
    out.update(mlp_with_head(wm_params["representation_model"], "rssm.representation_model"))
    out.update(mlp_with_head(wm_params["transition_model"], "rssm.transition_model"))
    out["rssm.initial_recurrent_state"] = _t(wm_params["initial_recurrent_state"])
    out.update(observation_model(wm_params["observation_model"]))
    out.update(mlp_with_head(wm_params["reward_model"], "reward_model"))
    out.update(mlp_with_head(wm_params["continue_model"], "continue_model"))
    return out


def actor_state_dict(actor_params: Mapping[str, Any]) -> StateDict:
    tree = _params(actor_params)
    out: StateDict = {}
    _mlp(tree["MLP_0"], "mlp", out, _n_dense(tree["MLP_0"]))
    for k in tree:
        if k.startswith("head_"):
            _dense(tree[k], f"heads.{k[len('head_'):]}", out)
    return out


def critic_state_dict(critic_params: Mapping[str, Any]) -> StateDict:
    return mlp_with_head(critic_params)
