"""Checkpoint file container of the port (counterpart of
sheeprl_tpu/utils/checkpoint.py: the version-1 file format, ``load_state`` and
``CheckpointCallback``), without JAX.

A file holds three pickles: a header ``{"__format__", "format_version",
"manifest"}``, the state (its CRC32 computed while it streams) and a footer
``{"crc32"}``. The manifest maps every array leaf's path, written as
``jax.tree_util.keystr`` writes it (``['k']``, ``[i]``, ``.field``), to its
shape and dtype, so the JAX package's ``load_state`` reads a port file and the
port reads a JAX file with the same checks on both sides.

The port writes plain containers only: dicts, tuples, lists, numpy arrays and
Python scalars. A JAX file also pickles its optimizer-state classes; the
restricted unpickler maps the ones a DreamerV3 or Dream-and-Ponder
checkpoint holds to local namedtuples with the same fields and refuses every other class with
:class:`CheckpointClassError`, which is not corruption and never falls back to
an older file.

Not ported: sharded (directory) checkpoints, writing certification sidecars
and the failpoints of the JAX container.
"""

from __future__ import annotations

import importlib
import io
import json
import os
import pickle
import re
import warnings
import zlib
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

_CKPT_MAGIC = "sheeprl_tpu_ckpt"
CKPT_FORMAT_VERSION = 1
CERTIFIED_SUFFIX = ".certified.json"

Manifest = Dict[str, Tuple[Tuple[int, ...], str]]


class CheckpointCorruptionError(RuntimeError):
    """The file exists but fails an integrity check: an unreadable pickle, a
    CRC or footer mismatch, or a state that differs from its manifest."""


class CheckpointClassError(RuntimeError):
    """The file pickles a class the port does not map; never a reason to fall
    back to an older checkpoint."""


# --------------------------------------------------------------------------- #
# the classes a JAX DreamerV3 or Dream-and-Ponder checkpoint pickles, as local namedtuples
# --------------------------------------------------------------------------- #


class EmptyState(NamedTuple):
    """``optax.EmptyState``: the state of ``clip_by_global_norm`` and of the
    learning-rate scale."""


class ScaleByAdamState(NamedTuple):
    """``optax.ScaleByAdamState``."""

    count: Any
    mu: Any
    nu: Any


class DV3OptStates(NamedTuple):
    """``sheeprl_tpu.algos.dreamer_v3.dreamer_v3.DV3OptStates``."""

    world: Any
    actor: Any
    critic: Any


class DAPOptStates(NamedTuple):
    """``sheeprl_tpu.algos.dream_and_ponder.dream_and_ponder.DAPOptStates``."""

    world: Any
    actor: Any
    critic: Any


_MAPPED_CLASSES = {
    ("optax._src.base", "EmptyState"): EmptyState,
    ("optax._src.transform", "ScaleByAdamState"): ScaleByAdamState,
    ("sheeprl_tpu.algos.dreamer_v3.dreamer_v3", "DV3OptStates"): DV3OptStates,
    ("sheeprl_tpu.algos.dream_and_ponder.dream_and_ponder", "DAPOptStates"): DAPOptStates,
}
# numpy's array and scalar reconstruction, under numpy 1's and numpy 2's module names
_NUMPY_GLOBALS = {
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"), ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"), ("numpy._core.multiarray", "scalar"),
    ("numpy.core.numeric", "_frombuffer"), ("numpy._core.numeric", "_frombuffer"),
}


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        mapped = _MAPPED_CLASSES.get((module, name))
        if mapped is not None:
            return mapped
        if (module, name) not in _NUMPY_GLOBALS:
            raise CheckpointClassError(
                f"the checkpoint pickles {module}.{name}, a class the port does not map "
                f"(it maps {sorted(f'{m}.{n}' for m, n in _MAPPED_CLASSES)} and numpy arrays)"
            )
        for candidate in (module, module.replace("numpy._core", "numpy.core"), module.replace("numpy.core", "numpy._core")):
            try:
                return getattr(importlib.import_module(candidate), name)
            except (ImportError, AttributeError):
                continue
        raise CheckpointClassError(f"numpy has no {module}.{name} here")


def _restricted_load(f) -> Any:
    return _RestrictedUnpickler(f).load()


# --------------------------------------------------------------------------- #
# manifest
# --------------------------------------------------------------------------- #


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _flatten_with_keystr(tree: Any, prefix: str = ""):
    """``(path, leaf)`` pairs in the order and notation of
    ``jax.tree_util.tree_flatten_with_path`` and ``keystr`` for dicts (sorted
    keys), lists, tuples and namedtuples; ``None`` holds no leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _flatten_with_keystr(tree[key], f"{prefix}[{key!r}]")
    elif _is_namedtuple(tree):
        for field, value in zip(type(tree)._fields, tree):
            yield from _flatten_with_keystr(value, f"{prefix}.{field}")
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _flatten_with_keystr(value, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _manifest(tree: Any) -> Manifest:
    """``{leaf path: (shape, dtype)}`` for every numpy array leaf of the state."""
    return {path: (tuple(int(d) for d in leaf.shape), str(leaf.dtype))
            for path, leaf in _flatten_with_keystr(tree) if isinstance(leaf, np.ndarray)}


def assert_same_tree(got: Any, want: Any, label: str = "state") -> int:
    """Bitwise equality of two checkpoint trees: the same leaf paths, arrays of
    the same shape, dtype and bytes, other leaves equal. Raises
    ``AssertionError`` naming the first leaf that differs; returns the number
    of arrays compared."""
    a, b = list(_flatten_with_keystr(got)), list(_flatten_with_keystr(want))
    if [p for p, _ in a] != [p for p, _ in b]:
        extra = sorted({p for p, _ in a} ^ {p for p, _ in b})[:5]
        raise AssertionError(f"{label}: the trees differ in their leaves (first differing paths: {extra})")
    for (path, x), (_, y) in zip(a, b):
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            x, y = np.asarray(x), np.asarray(y)
            if x.dtype != y.dtype or x.shape != y.shape or x.tobytes() != y.tobytes():
                raise AssertionError(f"{label}: leaf {path} differs ({x.shape} {x.dtype} vs {y.shape} {y.dtype})")
        elif x != y:
            raise AssertionError(f"{label}: leaf {path} differs ({x!r} vs {y!r})")
    return sum(isinstance(x, np.ndarray) for _, x in a)


def tree_crc32(tree: Any) -> int:
    """CRC32 over every array leaf of ``tree`` in :func:`_flatten_with_keystr`
    order: its path, dtype, shape and bytes. Two trees of the same leaves and
    bytes give the same value, whichever package wrote them."""
    crc = 0
    for path, leaf in _flatten_with_keystr(tree):
        if isinstance(leaf, np.ndarray):
            crc = zlib.crc32(f"{path}|{leaf.dtype}|{leaf.shape}".encode(), crc)
            crc = zlib.crc32(np.ascontiguousarray(leaf).tobytes(), crc)
    return crc


# --------------------------------------------------------------------------- #
# the container
# --------------------------------------------------------------------------- #


class _CrcWriter:
    """File wrapper computing a running CRC of what is written through it, so
    the state pickle streams to disk without a staging copy."""

    def __init__(self, f):
        self._f = f
        self.crc = 0

    def write(self, b):
        self.crc = zlib.crc32(b, self.crc)
        return self._f.write(b)


class _CrcReader:
    """File wrapper computing a running CRC of what is read through it; pickle
    protocol >= 4 frames its stream, so the CRC covers exactly the state."""

    def __init__(self, f):
        self._f = f
        self.crc = 0

    def read(self, n=-1):
        b = self._f.read(n)
        self.crc = zlib.crc32(b, self.crc)
        return b

    def readline(self, n=-1):
        b = self._f.readline(n)
        self.crc = zlib.crc32(b, self.crc)
        return b


def _fsync_dir(dirname: str) -> None:
    try:
        dfd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(dfd)
    except OSError:
        pass
    finally:
        os.close(dfd)


def save_state(path: str, state: Dict[str, Any]) -> Dict[str, Any]:
    """Write ``state`` (plain containers and numpy arrays) to ``path`` through a
    temp file: the file is fsync'd, and its directory before and after the
    ``os.replace``, so a crash leaves the old file or the whole new one.
    Returns ``{"crc32", "size"}``."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        header = {"__format__": _CKPT_MAGIC, "format_version": CKPT_FORMAT_VERSION, "manifest": _manifest(state)}
        pickle.dump(header, f, protocol=pickle.HIGHEST_PROTOCOL)
        writer = _CrcWriter(f)
        pickle.dump(state, writer, protocol=pickle.HIGHEST_PROTOCOL)
        pickle.dump({"crc32": writer.crc}, f, protocol=pickle.HIGHEST_PROTOCOL)
        f.flush()
        os.fsync(f.fileno())
        size = f.tell()
    _fsync_dir(parent)
    os.replace(tmp, path)
    _fsync_dir(parent)
    return {"crc32": writer.crc, "size": size}


def _refuse_directory(path: str) -> None:
    if os.path.isdir(path):
        raise NotImplementedError(
            f"'{path}' is a directory, a sharded checkpoint of the JAX package; the port reads "
            "single-file checkpoints only (checkpoint.sharded=False)"
        )


def read_manifest(path: str) -> Optional[Manifest]:
    """The stored manifest, from the header pickle alone (None for a file
    without the version-1 header)."""
    _refuse_directory(path)
    with open(path, "rb") as f:
        obj = _restricted_load(f)
    if isinstance(obj, dict) and obj.get("__format__") == _CKPT_MAGIC:
        return obj.get("manifest")
    return None


def _load_state_file(path: str) -> Dict[str, Any]:
    _refuse_directory(path)
    try:
        with open(path, "rb") as f:
            obj = _restricted_load(f)
            if not (isinstance(obj, dict) and obj.get("__format__") == _CKPT_MAGIC):
                return obj  # legacy bare-dict checkpoint
            version = obj.get("format_version")
            if not isinstance(version, int) or version > CKPT_FORMAT_VERSION:
                raise RuntimeError(f"Checkpoint '{path}' has format_version {version}; the port reads "
                                   f"<= {CKPT_FORMAT_VERSION}")
            reader = _CrcReader(f)
            state = _restricted_load(reader)
            footer = _restricted_load(f)
            if not isinstance(footer, dict):
                raise pickle.UnpicklingError(f"footer is a {type(footer).__name__}, not a dict")
    except (RuntimeError, OSError):
        raise  # CheckpointClassError, a newer format, a missing file: not corruption
    except Exception as e:
        # corruption inside a pickle stream surfaces as almost any exception
        raise CheckpointCorruptionError(
            f"Checkpoint '{path}' is unreadable (truncated, corrupt, or not a checkpoint): {type(e).__name__}: {e}"
        ) from e
    if reader.crc != footer.get("crc32"):
        raise CheckpointCorruptionError(f"Checkpoint '{path}' failed its integrity check (CRC mismatch)")
    stored = obj.get("manifest")
    if stored is not None:
        actual = _manifest(state)
        if stored != actual:
            diff = sorted(set(stored) ^ set(actual))[:5] or [k for k in sorted(stored) if stored[k] != actual.get(k)][:5]
            raise CheckpointCorruptionError(
                f"Checkpoint '{path}' state does not match its manifest (first differing leaves: {diff})")
    return state


def read_footer_crc(path: str) -> Optional[int]:
    """The CRC of a version-1 file's footer, from a read of its last bytes."""
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            f.seek(max(size - 128, 0))
            tail = f.read()
    except OSError:
        return None
    for i in range(len(tail) - 2, -1, -1):
        if tail[i] != 0x80:  # PROTO starts every pickle of protocol >= 2
            continue
        try:
            obj = _restricted_load(io.BytesIO(tail[i:]))
        except Exception:
            continue
        if isinstance(obj, dict) and "crc32" in obj:
            return obj.get("crc32")
    return None


def is_certified(path: str) -> bool:
    """True when ``path`` has a ``.certified.json`` sidecar (written by the JAX
    package's health sentinel) whose size and CRC still match the file."""
    try:
        with open(path + CERTIFIED_SUFFIX) as f:
            payload = json.load(f)
    except (OSError, ValueError):
        return False
    if not (isinstance(payload, dict) and payload.get("certified") is True):
        return False
    size = payload.get("size")
    try:
        if size is not None and os.path.getsize(path) != size:
            return False
    except OSError:
        return False
    crc = payload.get("crc32")
    if crc is not None:
        footer_crc = read_footer_crc(path)
        if footer_crc is not None and footer_crc != crc:
            return False
    return os.path.exists(path)


def _sort_key(path: str) -> Tuple[float, int, str]:
    """Order of sibling checkpoints: mtime, then the policy step of the name
    (mtime ties), then the name."""
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        mtime = 0.0
    return mtime, ckpt_step(path), os.path.basename(path)


def latest_certified(ckpt_dir: str) -> Optional[str]:
    """The newest certified ``*.ckpt`` of ``ckpt_dir`` by :func:`_sort_key`, or
    None (counterpart of the JAX package's ``latest_certified``)."""
    try:
        names = os.listdir(ckpt_dir)
    except OSError:
        return None
    certified = [os.path.join(ckpt_dir, n) for n in names
                 if n.endswith(".ckpt") and is_certified(os.path.join(ckpt_dir, n))]
    return max(certified, key=_sort_key) if certified else None


def _older_sibling_ckpts(path: str) -> List[str]:
    """Sibling ``*.ckpt`` files older than ``path``, newest first."""
    ckpt_dir = os.path.dirname(os.path.abspath(path)) or "."
    try:
        own_mtime: Optional[float] = os.path.getmtime(path)
    except OSError:
        own_mtime = None
    out: List[Tuple[float, str]] = []
    try:
        names = os.listdir(ckpt_dir)
    except OSError:
        return []
    for name in names:
        cand = os.path.join(ckpt_dir, name)
        if not name.endswith(".ckpt") or os.path.abspath(cand) == os.path.abspath(path):
            continue
        try:
            mtime = os.path.getmtime(cand)
        except OSError:
            continue
        if own_mtime is None or mtime < own_mtime:
            out.append((mtime, cand))
    return [p for _, p in sorted(out, reverse=True)]


def load_state(path: str, fallback_to_older: bool = True) -> Dict[str, Any]:
    """Load a checkpoint. On corruption (an unreadable pickle, a CRC, footer or
    manifest failure) fall back to the newest older ``*.ckpt`` beside it,
    certified ones first, with a warning; any other error is raised."""
    try:
        return _load_state_file(path)
    except CheckpointCorruptionError as primary:
        if not fallback_to_older:
            raise
        siblings = _older_sibling_ckpts(path)
        ordered = [c for c in siblings if is_certified(c)] + [c for c in siblings if not is_certified(c)]
        for cand in ordered:
            try:
                state = _load_state_file(cand)
            except CheckpointCorruptionError:
                continue
            warnings.warn(f"Checkpoint '{path}' is corrupt ({primary}); resumed from the newest "
                          f"older sibling '{cand}' instead.")
            return state
        raise


def ckpt_step(path: str) -> int:
    """The policy step in a ``ckpt_<step>_<rank>.ckpt`` name (-1 if none)."""
    ints = re.findall(r"\d+", os.path.basename(path))
    return int(ints[0]) if ints else -1


class CheckpointCallback:
    """Saves a training state (counterpart of the JAX package's
    ``CheckpointCallback.on_checkpoint_coupled``).

    With a replay buffer, the last ``truncated`` flag of every env stream is
    set before the save, so a resumed run treats the episodes in flight as
    truncated, and restored after it. ``keep_last`` removes all but the newest
    ``keep_last`` checkpoints of the directory.
    """

    def __init__(self, keep_last: Optional[int] = None):
        self.keep_last = keep_last

    def on_checkpoint_coupled(self, ckpt_path: str, state: Dict[str, Any], replay_buffer=None) -> Dict[str, Any]:
        originals = None
        if replay_buffer is not None:
            originals = replay_buffer._patch_truncated()
            state = dict(state, rb=replay_buffer.state_dict())
        try:
            info = save_state(ckpt_path, state)
        finally:
            if replay_buffer is not None:
                replay_buffer._unpatch_truncated(originals)
        self._gc(os.path.dirname(ckpt_path))
        return info

    def _gc(self, ckpt_dir: str) -> None:
        if not self.keep_last:
            return
        try:
            names = [f for f in os.listdir(ckpt_dir) if f.endswith(".ckpt")]
        except FileNotFoundError:
            return

        def order(name: str):
            full = os.path.join(ckpt_dir, name)
            try:
                mtime = os.path.getmtime(full)
            except OSError:
                mtime = 0.0
            return mtime, ckpt_step(full), name

        for name in sorted(names, key=order)[: -self.keep_last]:
            try:
                os.remove(os.path.join(ckpt_dir, name))
            except OSError:
                pass
