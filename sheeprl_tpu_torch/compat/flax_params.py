"""The JAX package's DreamerV3 and Dream-and-Ponder parameter and optimizer
trees, both ways.

The flax trees (numpy arrays, as ``jax.device_get`` gives them and as a
checkpoint holds them) and the port's ``state_dict`` names correspond leaf by
leaf:

- Dense ``kernel [in, out]`` <-> Linear ``weight [out, in]``;
- Conv ``kernel [kh, kw, in, out]`` (HWIO) <-> Conv2d ``weight [out, in, kh, kw]``;
- ConvTranspose ``kernel [kh, kw, out, in]`` (``transpose_kernel=True``) <->
  ConvTranspose2d ``weight [in, out, kh, kw]`` (the same permutation);
- LayerNorm ``scale``/``bias`` <-> ``weight``/``bias``;
- the GRU's fused ``[h, x]`` kernel <-> ``gru.weight`` (same column order);
- ``initial_recurrent_state`` as is.

Module paths follow :data:`_TOKEN_RULES` (``mlp.linears.0`` <->
``MLP_0/Dense_0``, ``heads.0`` <-> ``head_0``, ...); each module's tree sits
under ``params`` as flax writes it. A ``roots`` mapping names the flax path of
each torch name prefix: :data:`WORLD_MODEL_ROOTS`, :data:`MODULE_ROOTS` and
:func:`ponder_actor_roots` (the ponder actor's three MLPs, whose layers flax
numbers under the attribute's own name).

The optimizer state: ``optax.chain(clip_by_global_norm, adam)`` (or adam alone
when the clip is off, as ``with_clipping`` builds it) holds ``(EmptyState,
(ScaleByAdamState(count, mu, nu), EmptyState))``; ``mu``/``nu`` are trees of
the parameters' layout and map to ``torch.optim.Adam``'s per-parameter
``exp_avg``/``exp_avg_sq`` with the same transforms, ``count`` to its ``step``.
The port writes that state as plain containers: a namedtuple becomes the dict
of its fields and ``EmptyState`` the empty tuple.

Images cross the boundary in NCHW on both sides (the flax modules transpose to
NHWC internally), so no activation layout changes. Imports no JAX or optax.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, Iterator, List, Mapping, Tuple

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]
Path = Tuple[str, ...]

#: torch name tokens <-> flax keys; ``{i}`` is an index, ``{k}`` a name
_TOKEN_RULES = (
    (("mlp", "norms", "{i}"), ("MLP_0", "LayerNorm_{i}", "LayerNorm_0")),
    (("cnn", "norms", "{i}"), ("CNN_0", "LayerNorm_{i}", "LayerNorm_0")),
    (("deconv", "norms", "{i}"), ("DeCNN_0", "LayerNorm_{i}", "LayerNorm_0")),
    (("mlp", "linears", "{i}"), ("MLP_0", "Dense_{i}")),
    (("cnn", "convs", "{i}"), ("CNN_0", "Conv_{i}")),
    (("deconv", "deconvs", "{i}"), ("DeCNN_0", "ConvTranspose_{i}")),
    (("heads", "{k}"), ("head_{k}",)),
    (("linear",), ("Dense_0",)),
    (("gru",), ("LayerNormGRUCell_0",)),
)
_LEAF_TO_FLAX = {"bias": "bias", "ln_weight": "ln_scale", "ln_bias": "ln_bias"}
_LEAF_TO_TORCH = {"kernel": "weight", "scale": "weight", "bias": "bias", "ln_scale": "ln_weight",
                  "ln_bias": "ln_bias"}

#: torch name prefix -> flax path of the module, for the world model
WORLD_MODEL_ROOTS: Dict[str, Path] = {
    "encoder": ("encoder", "params"),
    "rssm.recurrent_model": ("recurrent_model", "params"),
    "rssm.representation_model": ("representation_model", "params"),
    "rssm.transition_model": ("transition_model", "params"),
    "rssm.initial_recurrent_state": ("initial_recurrent_state",),
    "observation_model": ("observation_model", "params"),
    "reward_model": ("reward_model", "params"),
    "continue_model": ("continue_model", "params"),
}
#: the actor and the critics are one flax module each
MODULE_ROOTS: Dict[str, Path] = {"": ("params",)}


def ponder_actor_roots(mlp_layers: int) -> Dict[str, Path]:
    """torch name prefix -> flax path for the Dream-and-Ponder actor of
    ``mlp_layers`` (the JAX ``PonderActor``). Its three MLPs are flax ``MLP``
    attributes, so their layers sit under the attribute's name, numbered
    ``Dense_0`` ... ``Dense_{n-1}`` (hidden, each followed by
    ``LayerNorm_{i}/LayerNorm_0``) and ``Dense_{n}`` (the output head, where
    there is one); ``heads.{i}`` and ``no_goal_yet`` follow :data:`MODULE_ROOTS`.
    Hidden depths: ``ceil(0.8 * mlp_layers)`` for the goal module,
    ``ceil(0.4 * mlp_layers)`` for the halt module and the action decoder."""
    roots: Dict[str, Path] = {"": ("params",), "no_goal_yet": ("params", "no_goal_yet")}
    for module, share, has_head in (("goal_ponder_module", 0.8, True), ("halt_module", 0.4, True),
                                    ("action_decoder", 0.4, False)):
        hidden = math.ceil(mlp_layers * share)
        base = ("params", module)
        for i in range(hidden):
            roots[f"{module}.linears.{i}"] = base + (f"Dense_{i}",)
            roots[f"{module}.norms.{i}"] = base + (f"LayerNorm_{i}", "LayerNorm_0")
        if has_head:
            roots[f"{module}.head"] = base + (f"Dense_{hidden}",)
    return roots


def _compile(pattern: Tuple[str, ...]):
    return [re.compile("^" + re.escape(t).replace(r"\{i\}", r"(?P<i>\d+)").replace(r"\{k\}", r"(?P<k>\w+)") + "$")
            for t in pattern]


_FORWARD = [(_compile(src), dst) for src, dst in _TOKEN_RULES]  # torch -> flax
_BACKWARD = [(_compile(dst), src) for src, dst in _TOKEN_RULES]  # flax -> torch


def _translate(tokens: List[str], rules) -> List[str]:
    out, i = [], 0
    while i < len(tokens):
        for regexes, target in rules:
            window = tokens[i:i + len(regexes)]
            matches = [r.match(t) for r, t in zip(regexes, window)]
            if len(window) == len(regexes) and all(matches):
                groups = {k: v for m in matches for k, v in m.groupdict().items()}
                out += [t.format(**groups) for t in target]
                i += len(regexes)
                break
        else:
            out.append(tokens[i])
            i += 1
    return out


def flax_path(name: str, roots: Mapping[str, Path]) -> Path:
    """The flax path of the port's parameter ``name``."""
    if name in roots:
        return roots[name]
    root = max((r for r in roots if r == "" or name.startswith(r + ".")), key=len, default=None)
    if root is None:
        raise KeyError(f"the port's parameter {name!r} lies under none of {sorted(roots)}")
    tokens = name[len(root) + 1 if root else 0:].split(".")
    prefix = roots[root] + tuple(_translate(tokens[:-1], _FORWARD))
    leaf = tokens[-1]
    if leaf == "weight":
        leaf = "scale" if prefix[-1] == "LayerNorm_0" else "kernel"
    elif leaf in _LEAF_TO_FLAX:
        leaf = _LEAF_TO_FLAX[leaf]
    else:
        raise KeyError(f"the port's parameter {name!r} has no flax counterpart")
    return prefix + (leaf,)


def torch_name(path: Path, roots: Mapping[str, Path]) -> str:
    """The port's parameter name of the flax leaf at ``path``."""
    for root, prefix in sorted(roots.items(), key=lambda kv: -len(kv[1])):
        if tuple(path[:len(prefix)]) == prefix:
            rest = list(path[len(prefix):])
            if not rest:
                return root
            if rest[-1] not in _LEAF_TO_TORCH:
                break
            tokens = _translate(rest[:-1], _BACKWARD) + [_LEAF_TO_TORCH[rest[-1]]]
            return ".".join(([root] if root else []) + tokens)
    raise KeyError(f"the flax leaf {'/'.join(path)} has no counterpart among the port's parameters")


def _to_torch_layout(path: Path, x: np.ndarray) -> np.ndarray:
    if path[-1] == "kernel":
        if x.ndim == 2:
            return x.T
        if x.ndim == 4:
            return x.transpose(3, 2, 0, 1)
    return x


def _to_flax_layout(path: Path, x: np.ndarray) -> np.ndarray:
    if path[-1] == "kernel":
        if x.ndim == 2:
            return x.T
        if x.ndim == 4:
            return x.transpose(2, 3, 1, 0)
    return x


def _leaves(tree: Mapping[str, Any], prefix: Path = ()) -> Iterator[Tuple[Path, Any]]:
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _get(tree: Mapping[str, Any], path: Path) -> Any:
    node: Any = tree
    for key in path:
        if not isinstance(node, Mapping) or key not in node:
            raise KeyError("/".join(path))
        node = node[key]
    return node


def _set(tree: Dict[str, Any], path: Path, value: Any) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _wrap(tree: Mapping[str, Any], roots: Mapping[str, Path]) -> Mapping[str, Any]:
    """Accept a single module's tree with or without its ``params`` level."""
    if roots.get("") == ("params",) and "params" not in tree:
        return {"params": tree}
    return tree


def to_state_dict(tree: Mapping[str, Any], roots: Mapping[str, Path] = MODULE_ROOTS) -> StateDict:
    """flax tree -> the port's ``state_dict`` (float32 tensors)."""
    return {torch_name(path, roots): torch.from_numpy(np.array(_to_torch_layout(path, np.asarray(x)), dtype=np.float32))
            for path, x in _leaves(_wrap(tree, roots))}


def to_flax(named: Mapping[str, Any], roots: Mapping[str, Path] = MODULE_ROOTS) -> Dict[str, Any]:
    """The port's ``{name: tensor}`` -> flax tree of float32 numpy arrays."""
    out: Dict[str, Any] = {}
    for name, t in named.items():
        path = flax_path(name, roots)
        _set(out, path, np.ascontiguousarray(_to_flax_layout(path, t.detach().cpu().numpy())))
    return out


def world_model_state_dict(wm_params: Mapping[str, Any]) -> StateDict:
    """The JAX world-model param dict -> the port's ``WorldModel.state_dict()``."""
    return to_state_dict(wm_params, WORLD_MODEL_ROOTS)


# --------------------------------------------------------------------------- #
# loading into modules, with a named error for a tree that does not fit
# --------------------------------------------------------------------------- #


def _describe(x: Any) -> str:
    return f"shape {tuple(np.shape(x))} dtype {np.asarray(x).dtype}"


def module_loader(module: torch.nn.Module, tree: Mapping[str, Any], roots: Mapping[str, Path],
                  what: str) -> Callable[[], None]:
    """Check a flax tree against ``module``'s parameters; returns the function
    that copies it in. Raises, naming the first leaf that differs by path,
    shape and dtype, when the tree does not fit the module."""
    tree = _wrap(tree, roots)
    params = dict(module.named_parameters())
    pending = []
    for name, p in params.items():
        path = flax_path(name, roots)
        try:
            x = np.asarray(_get(tree, path))
        except KeyError:
            raise ValueError(f"{what}: the checkpoint has no leaf {'/'.join(path)} for the port's {name} "
                             f"(shape {tuple(p.shape)} float32)") from None
        x = _to_torch_layout(path, x)
        if tuple(x.shape) != tuple(p.shape) or x.dtype != np.float32:
            raise ValueError(f"{what}: leaf {'/'.join(path)} has {_describe(x)} in the port's layout; the model's "
                             f"{name} has shape {tuple(p.shape)} dtype float32")
        pending.append((p, x))
    expected = {flax_path(n, roots) for n in params}
    extra = [path for path, _ in _leaves(tree) if path not in expected]
    if extra:
        raise ValueError(f"{what}: the checkpoint's leaf {'/'.join(extra[0])} ({_describe(_get(tree, extra[0]))}) "
                         "has no parameter in the port's model")

    @torch.no_grad()
    def apply() -> None:
        for p, x in pending:
            p.copy_(torch.from_numpy(np.require(x, requirements=("C", "W"))))

    return apply


# --------------------------------------------------------------------------- #
# optimizer state
# --------------------------------------------------------------------------- #


def _plain(x: Any) -> Any:
    """Namedtuples -> dicts of their fields, ``EmptyState`` -> ``()`` (the
    port's own files hold these)."""
    if isinstance(x, tuple) and hasattr(type(x), "_fields"):
        return {f: _plain(v) for f, v in zip(type(x)._fields, x)} if x else ()
    if isinstance(x, tuple):
        return tuple(_plain(v) for v in x)
    return x


def _layout(state: Any) -> str:
    def name(x):
        if isinstance(x, dict):
            return "ScaleByAdamState" if set(x) == {"count", "mu", "nu"} else f"dict{sorted(x)}"
        if isinstance(x, tuple):
            return "(" + ", ".join(name(v) for v in x) + ")" if x else "EmptyState"
        return type(x).__name__
    return name(state)


_ADAM = "(ScaleByAdamState, EmptyState)"
_LAYOUTS = {True: f"(EmptyState, {_ADAM})", False: _ADAM}


def adam_loader(optimizer: torch.optim.Optimizer, named_params: Mapping[str, torch.nn.Parameter], state: Any,
                roots: Mapping[str, Path], clipped: bool, what: str) -> Callable[[], None]:
    """Check an optax chain state against ``optimizer``; returns the function
    that sets its Adam state (``step``, ``exp_avg``, ``exp_avg_sq`` of every
    parameter). Raises, naming the layout, for any chain other than the one
    ``with_clipping`` builds, and naming the leaf for a tree that does not fit."""
    state = _plain(state)
    layout = _layout(state)
    if layout != _LAYOUTS[clipped]:
        raise ValueError(f"{what}: the checkpoint's optimizer state is {layout}; the port maps only "
                         f"optax.chain(clip_by_global_norm, adam) {_LAYOUTS[True]} and adam {_LAYOUTS[False]}, "
                         f"and this run expects {_LAYOUTS[clipped]}")
    adam = state[1][0] if clipped else state[0]
    count = float(np.asarray(adam["count"]))
    pending = []
    for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        tree = _wrap(adam[moment], roots)
        for name, p in named_params.items():
            path = flax_path(name, roots)
            try:
                x = _to_torch_layout(path, np.asarray(_get(tree, path)))
            except KeyError:
                raise ValueError(f"{what}: the optimizer state has no {moment} leaf {'/'.join(path)} "
                                 f"for the port's {name}") from None
            if tuple(x.shape) != tuple(p.shape) or x.dtype != np.float32:
                raise ValueError(f"{what}: {moment} leaf {'/'.join(path)} has {_describe(x)} in the port's layout; "
                                 f"the model's {name} has shape {tuple(p.shape)} dtype float32")
            pending.append((p, key, x))

    def apply() -> None:
        optimizer.state.clear()
        for p, key, x in pending:
            st = optimizer.state[p]
            st.setdefault("step", torch.tensor(count, dtype=torch.float32))
            st[key] = torch.from_numpy(np.require(x, requirements=("C", "W"))).to(p.device)

    return apply


def adam_state_to_optax(optimizer: torch.optim.Optimizer, named_params: Mapping[str, torch.nn.Parameter],
                        roots: Mapping[str, Path], clipped: bool) -> tuple:
    """``optimizer``'s Adam state as the plain containers of the optax chain
    state: ``((), ({"count", "mu", "nu"}, ()))`` with the clip, else
    ``({"count", "mu", "nu"}, ())``."""
    steps = {float(optimizer.state[p]["step"]) for p in named_params.values() if p in optimizer.state}
    if len(steps) > 1:
        raise ValueError(f"the optimizer's parameters have taken different numbers of steps: {sorted(steps)}")
    mu, nu = {}, {}
    for name, p in named_params.items():
        st = optimizer.state.get(p, {})
        mu[name] = st.get("exp_avg", torch.zeros_like(p))
        nu[name] = st.get("exp_avg_sq", torch.zeros_like(p))
    adam = {"count": np.asarray(int(steps.pop()) if steps else 0, dtype=np.int32),
            "mu": to_flax(mu, roots), "nu": to_flax(nu, roots)}
    return ((), (adam, ())) if clipped else (adam, ())
