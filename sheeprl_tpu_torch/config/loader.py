"""Config composition for the port: the subset of Hydra the config tree uses.

Counterpart of ``sheeprl_tpu/config/loader.py``, without PyYAML (the card's
machine lacks it): :func:`parse_yaml` reads the YAML subset of
``sheeprl_tpu_torch/configs`` and of what ``yaml.safe_dump`` writes (block
mappings and lists, flow collections, plain and quoted scalars, folded lines,
comments), and :func:`dump_yaml` writes a config in a subset both it and
PyYAML read back unchanged (the run's ``config.yaml`` sidecar, counterpart of
``save_configs``). :func:`compose` then builds the run config:

- the root ``config.yaml`` and its ``defaults:`` list of ``group: option``;
- an experiment (``exp=<name>``, ``# @package _global_``) whose
  ``override /group: option`` entries re-select groups and whose body merges at
  the top level;
- inside a group file, sibling includes (``- default``) and placed groups
  (``- /optim@world_model.optimizer: adam``);
- CLI arguments: ``group=option`` selects a group, ``a.b.c=value`` sets a key;
  CLI selections win over the experiment's overrides;
- ``${a.b.c}`` and ``${now:<strftime>}`` interpolation.

:func:`instantiate` imports a ``_target_`` and calls it (``_partial_: True``
returns a ``functools.partial``).
"""

from __future__ import annotations

import copy
import datetime
import functools
import importlib
import json
import math
import os
import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from sheeprl_tpu_torch.utils.utils import dotdict

MISSING = "???"
CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


class ConfigError(RuntimeError):
    pass


# --------------------------------------------------------------------------- #
# YAML subset
# --------------------------------------------------------------------------- #

_INT_RE = re.compile(r"^[-+]?[0-9]+$")
_FLOAT_RE = re.compile(r"^[-+]?(?:[0-9]+\.[0-9]*(?:[eE][-+]?[0-9]+)?|[0-9]+[eE][-+]?[0-9]+|\.[0-9]+(?:[eE][-+]?[0-9]+)?)$")
# YAML 1.1 booleans, as PyYAML reads them (``kernels: off`` is False)
_SPECIAL = {
    **{w: True for w in ("true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON")},
    **{w: False for w in ("false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF")},
    "null": None, "Null": None, "NULL": None, "~": None, "": None,
    ".inf": float("inf"), "-.inf": float("-inf"), ".nan": float("nan"),
}


def _strip_comment(line: str) -> str:
    quote, escaped = None, False
    for i, ch in enumerate(line):
        if quote:
            if escaped:
                escaped = False
            elif ch == "\\" and quote == '"':
                escaped = True
            elif ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _split_flow(body: str) -> List[str]:
    """Split the inside of a flow collection at top-level commas."""
    parts, depth, quote, escaped, cur = [], 0, None, False, ""
    for ch in body:
        if quote:
            if escaped:
                escaped = False
            elif ch == "\\" and quote == '"':
                escaped = True
            elif ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append(cur.strip())
            cur = ""
            continue
        cur += ch
    if cur.strip():
        parts.append(cur.strip())
    return parts


def parse_scalar(text: str) -> Any:
    """One YAML scalar or flow collection."""
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] == "'":
        return text[1:-1].replace("''", "'")
    if len(text) >= 2 and text[0] == text[-1] == '"':
        try:
            return json.loads(text)  # JSON's escapes, the subset of YAML's that dump_yaml and PyYAML write for text
        except ValueError as e:
            raise ConfigError(f"double-quoted YAML string {text!r} uses an escape the reader does not take: {e}") from e
    if text.startswith("[") and text.endswith("]"):
        return [parse_scalar(p) for p in _split_flow(text[1:-1])]
    if text.startswith("{") and text.endswith("}"):
        out = {}
        for part in _split_flow(text[1:-1]):
            key, _, value = part.partition(":")
            out[parse_scalar(key)] = parse_scalar(value)
        return out
    if text in _SPECIAL:
        return _SPECIAL[text]
    if _INT_RE.match(text):
        return int(text)
    if _FLOAT_RE.match(text):
        return float(text)
    return text


_KEY_RE = re.compile(r"""^("(?:[^"\\]|\\.)*"|'(?:[^']|'')*'|[^:#"'][^:#]*?):(?:\s+(.*)|$)""")


def _split_key(content: str) -> Optional[Tuple[str, str]]:
    """``key: value`` -> (key, value); None when the line is not a mapping entry."""
    if content[:1] in "[{":
        return None
    m = _KEY_RE.match(content)
    if m is None:
        return None
    key = m.group(1).strip()
    if key[:1] in "\"'":
        key = parse_scalar(key)
    return key, (m.group(2) or "")


def parse_yaml(text: str) -> Any:
    """Parse the YAML subset of the port's config tree."""
    lines = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise ConfigError(f"line {lineno}: tabs are not allowed in indentation")
        content = _strip_comment(raw)
        if content.strip():
            lines.append([len(content) - len(content.lstrip()), content.strip(), lineno])
    if not lines:
        return None
    value, i = _parse_block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ConfigError(f"line {lines[i][2]}: unexpected indentation")
    return value


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


def _parse_block(lines, i: int, indent: int):
    if _is_item(lines[i][1]):
        return _parse_list(lines, i, indent)
    if _split_key(lines[i][1]) is None:
        return parse_scalar(lines[i][1]), i + 1
    return _parse_mapping(lines, i, indent)


def _parse_nested(lines, i: int, indent: int, allow_same_indent_list: bool):
    """The value of an entry whose inline part is empty: a deeper block, a list
    at the same indentation (``key:`` then ``- item``), or null."""
    if i < len(lines) and lines[i][0] > indent:
        return _parse_block(lines, i, lines[i][0])
    if allow_same_indent_list and i < len(lines) and lines[i][0] == indent and _is_item(lines[i][1]):
        return _parse_list(lines, i, indent)
    return None, i


def _parse_mapping(lines, i: int, indent: int):
    out: Dict[str, Any] = {}
    while i < len(lines) and lines[i][0] == indent and not _is_item(lines[i][1]):
        kv = _split_key(lines[i][1])
        if kv is None:
            raise ConfigError(f"line {lines[i][2]}: expected 'key: value', got {lines[i][1]!r}")
        key, rest = kv
        if rest:
            i += 1
            while i < len(lines) and lines[i][0] > indent:  # a scalar folded over more lines
                if lines[i][2] != lines[i - 1][2] + 1:
                    raise ConfigError(f"line {lines[i][2]}: a scalar folded over a blank line (a line break "
                                      "inside a string) is not read")
                rest += " " + lines[i][1]
                i += 1
            out[key] = parse_scalar(rest)
        else:
            out[key], i = _parse_nested(lines, i + 1, indent, allow_same_indent_list=True)
    return out, i


def _parse_list(lines, i: int, indent: int):
    out: List[Any] = []
    while i < len(lines) and lines[i][0] == indent and _is_item(lines[i][1]):
        rest = lines[i][1][1:].strip()
        if not rest:
            value, i = _parse_nested(lines, i + 1, indent, allow_same_indent_list=False)
        elif _is_item(rest):
            # a list item that is itself a block list: ``- - x``
            item_indent = indent + len(lines[i][1]) - len(rest)
            lines[i] = [item_indent, rest, lines[i][2]]
            value, i = _parse_list(lines, i, item_indent)
        elif _split_key(rest) is not None:
            # a mapping item: its keys sit at the column after "- "
            item_indent = indent + len(lines[i][1]) - len(rest)
            lines[i] = [item_indent, rest, lines[i][2]]
            value, i = _parse_mapping(lines, i, item_indent)
        else:
            value, i = parse_scalar(rest), i + 1
        out.append(value)
    return out, i


def load_yaml(path: str) -> Any:
    with open(path, encoding="utf-8") as f:
        return parse_yaml(f.read())


_PLAIN_KEY_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_./-]*$")


def _dump_scalar(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        if "e" in text and "." not in text.split("e")[0]:
            text = text.replace("e", ".0e")  # YAML 1.1 floats need a dot: 1.0e-05
        return text
    if isinstance(value, str):
        return json.dumps(value)
    raise ConfigError(f"cannot write a {type(value).__name__} ({value!r}) to YAML")


def _dump_key(key: Any) -> str:
    key = str(key)
    return key if _PLAIN_KEY_RE.match(key) and key not in _SPECIAL else json.dumps(key)


def _is_scalar(value: Any) -> bool:
    return not isinstance(value, (Mapping, list, tuple))


def _dump_lines(node: Any, indent: int) -> List[str]:
    pad = " " * indent
    lines: List[str] = []
    for key, value in node.items():
        head = f"{pad}{_dump_key(key)}:"
        if isinstance(value, Mapping) and value:
            lines += [head] + _dump_lines(value, indent + 2)
        elif isinstance(value, (list, tuple)) and not all(_is_scalar(v) for v in value):
            lines.append(head)
            for item in value:
                if isinstance(item, Mapping) and item:
                    sub = _dump_lines(item, indent + 4)
                    lines.append(f"{pad}  - {sub[0].lstrip()}")
                    lines += sub[1:]
                else:
                    lines.append(f"{pad}  - {_dump_flow(item)}")
        else:
            lines.append(f"{head} {_dump_flow(value)}")
    return lines


def _dump_flow(value: Any) -> str:
    if isinstance(value, Mapping):
        return "{" + ", ".join(f"{_dump_key(k)}: {_dump_flow(v)}" for k, v in value.items()) + "}"
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(_dump_flow(v) for v in value) + "]"
    return _dump_scalar(value)


def dump_yaml(cfg: Mapping[str, Any]) -> str:
    """A config as YAML that :func:`parse_yaml` and ``yaml.safe_load`` both
    read back as the same dict (block mappings, flow lists of scalars, strings
    double-quoted, floats with a dot)."""
    return "\n".join(_dump_lines(cfg, 0)) + "\n"


# --------------------------------------------------------------------------- #
# composition
# --------------------------------------------------------------------------- #


def _deep_merge(dst: Dict[str, Any], src: Mapping[str, Any]) -> Dict[str, Any]:
    for key, value in src.items():
        if key in dst and isinstance(dst[key], dict) and isinstance(value, Mapping):
            _deep_merge(dst[key], value)
        else:
            dst[key] = copy.deepcopy(value)
    return dst


def _set_at(root: Dict[str, Any], dotted: str, value: Any) -> None:
    node = root
    parts = dotted.split(".")
    for part in parts[:-1]:
        if not isinstance(node.get(part), dict):
            node[part] = {}
        node = node[part]
    if isinstance(node.get(parts[-1]), dict) and isinstance(value, dict):
        _deep_merge(node[parts[-1]], value)
    else:
        node[parts[-1]] = value


def _group_file(group: str, option: str) -> str:
    path = os.path.join(CONFIG_DIR, group, f"{option}.yaml")
    if not os.path.isfile(path):
        available = sorted(f[:-5] for f in os.listdir(os.path.join(CONFIG_DIR, group))) if os.path.isdir(
            os.path.join(CONFIG_DIR, group)) else []
        raise ConfigError(f"no config '{group}/{option}' in the port's tree (available: {available})")
    return path


def _defaults_entry(entry: Any) -> Tuple[str, Optional[str]]:
    if isinstance(entry, str):
        return entry.strip(), None
    if isinstance(entry, Mapping) and len(entry) == 1:
        key, value = next(iter(entry.items()))
        return str(key).strip(), None if value is None else str(value)
    raise ConfigError(f"malformed defaults entry {entry!r}")


def _compose_group_file(path: str, group: str) -> Dict[str, Any]:
    """One group file with its own defaults (sibling includes, placed groups)."""
    raw = load_yaml(path) or {}
    defaults = raw.pop("defaults", [])
    out: Dict[str, Any] = {}
    self_merged = False
    for entry in defaults:
        key, option = _defaults_entry(entry)
        if key == "_self_":
            _deep_merge(out, raw)
            self_merged = True
        elif option is None:
            _deep_merge(out, _compose_group_file(_group_file(group, key), group))
        else:
            sub_group, _, placement = key.lstrip("/").partition("@")
            sub = _compose_group_file(_group_file(sub_group, option), sub_group)
            _set_at(out, placement or sub_group, sub)
    if not self_merged:
        _deep_merge(out, raw)
    return out


def _parse_overrides(overrides: Sequence[str]) -> Tuple[Dict[str, str], List[Tuple[str, Any]]]:
    selections, sets = {}, []
    for item in overrides:
        if "=" not in item:
            raise ConfigError(f"override {item!r} is not key=value")
        key, value = item.split("=", 1)
        key = key.strip().lstrip("+")
        if "." not in key and os.path.isdir(os.path.join(CONFIG_DIR, key)):
            selections[key] = value.strip()
        else:
            sets.append((key, parse_scalar(value)))
    return selections, sets


_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


def _lookup(root: Mapping[str, Any], dotted: str) -> Any:
    node: Any = root
    for part in dotted.split("."):
        if not isinstance(node, Mapping) or part not in node:
            raise ConfigError(f"interpolation ${{{dotted}}} does not resolve")
        node = node[part]
    return node


def _resolve(expr: str, root: Mapping[str, Any], now: datetime.datetime) -> Any:
    expr = expr.strip()
    if expr.startswith("now:"):
        return now.strftime(expr[4:])
    return _lookup(root, expr)


def resolve_interpolations(cfg: Dict[str, Any], max_passes: int = 20) -> Dict[str, Any]:
    now = datetime.datetime.now()

    def visit(node):
        if isinstance(node, dict):
            return {k: visit(v) for k, v in node.items()}
        if isinstance(node, list):
            return [visit(v) for v in node]
        if isinstance(node, str) and "${" in node:
            full = _INTERP_RE.fullmatch(node.strip())
            if full:
                return copy.deepcopy(_resolve(full.group(1), cfg, now))
            return _INTERP_RE.sub(lambda m: str(_resolve(m.group(1), cfg, now)), node)
        return node

    for _ in range(max_passes):
        new = visit(cfg)
        if new == cfg:
            return new
        cfg = new
    raise ConfigError("interpolations do not settle (a reference cycle?)")


def _missing_keys(node: Any, prefix: str = "") -> List[str]:
    if isinstance(node, dict):
        return [m for k, v in node.items() for m in _missing_keys(v, f"{prefix}{k}.")]
    return [prefix[:-1]] if node == MISSING else []


def compose(overrides: Optional[Sequence[str]] = None) -> dotdict:
    """Compose the run config from the root file, group selections and CLI overrides."""
    selections, sets = _parse_overrides(list(overrides or []))
    root = load_yaml(os.path.join(CONFIG_DIR, "config.yaml"))
    defaults = root.pop("defaults")
    chosen: Dict[str, Optional[str]] = {}
    for entry in defaults:
        key, option = _defaults_entry(entry)
        if key != "_self_":
            chosen[key] = selections.get(key, option)
    unknown = set(selections) - set(chosen)
    if unknown:
        raise ConfigError(f"unknown config group(s) {sorted(unknown)}")

    exp_body: Dict[str, Any] = {}
    if chosen.get("exp") not in (None, MISSING, "null"):
        exp_raw = load_yaml(_group_file("exp", chosen["exp"])) or {}
        for entry in exp_raw.pop("defaults", []):
            key, option = _defaults_entry(entry)
            if key.startswith("override "):
                group = key[len("override "):].strip().lstrip("/")
                if group not in chosen:
                    raise ConfigError(f"exp/{chosen['exp']} overrides unknown group {group!r}")
                chosen[group] = selections.get(group, option)
            elif key != "_self_":
                _deep_merge(exp_body, _compose_group_file(_group_file("exp", key), "exp"))
        _deep_merge(exp_body, exp_raw)
    elif chosen.get("exp") == MISSING:
        raise ConfigError("no experiment selected: pass exp=<name> (e.g. exp=dreamer_v3)")

    cfg: Dict[str, Any] = {}
    for entry in defaults:
        key, _ = _defaults_entry(entry)
        if key == "_self_":
            _deep_merge(cfg, root)
        elif key != "exp" and chosen[key] not in (None, "null"):
            cfg[key] = _compose_group_file(_group_file(key, chosen[key]), key)
    _deep_merge(cfg, exp_body)
    for dotted, value in sets:
        _set_at(cfg, dotted, value)
    cfg = resolve_interpolations(cfg)
    missing = _missing_keys(cfg)
    if missing:
        raise ConfigError(f"mandatory values are missing: {missing}")
    return dotdict(cfg)


def instantiate(spec: Mapping[str, Any]):
    """``hydra.utils.instantiate`` for the port: import ``_target_`` and call it."""
    if not isinstance(spec, Mapping) or "_target_" not in spec:
        raise ConfigError(f"instantiate() needs a mapping with '_target_', got {spec!r}")
    module_name, _, attr = str(spec["_target_"]).rpartition(".")
    try:
        target = getattr(importlib.import_module(module_name), attr)
    except (ImportError, AttributeError) as e:
        raise ConfigError(f"cannot import _target_ {spec['_target_']!r}: {e}") from e
    params = {
        k: instantiate(v) if isinstance(v, Mapping) and "_target_" in v else v
        for k, v in spec.items()
        if k not in ("_target_", "_partial_")
    }
    if spec.get("_partial_", False):
        return functools.partial(target, **params)
    return target(**params)
