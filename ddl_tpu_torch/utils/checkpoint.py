"""Checkpoint / resume — the port of ``ddl_tpu/utils/checkpoint.py``.

This module is the contract between the two packages: a file written by
either loads in the other, bit for bit. It is the JAX module's format
kept byte for byte in meaning:

- one ``.npz`` per save, each array stored under its JAX ``keystr`` path
  (``['params']['blocks'][0]['wq']``, ``['opt'].step``, ``['state'].ps``:
  dict keys sorted, list and tuple items ``[i]``, dataclass and NamedTuple
  fields ``.name`` in declaration order), plus a ``__meta__`` member (the
  JSON of ``{"step", "extra"}`` as uint8 bytes);
- a sidecar manifest ``<file>.manifest.json`` (schema
  ``"ddl_tpu.ckpt.v1"``: the step and, for each array, its CRC32, shape
  and dtype), which :func:`verify_checkpoint` checks without trusting the
  zip container;
- durable writes: a temp file, ``fsync``, then ``os.replace`` (and a
  directory ``fsync``), so a crash mid-save never corrupts the previous
  checkpoint;
- retention: with ``keep=N`` and a step, each save is also kept as
  ``<stem>-<step:08d>.npz``, the rolling file is a hardlink of the newest,
  and older retained saves beyond the newest N are pruned, so a corrupt
  latest file leaves the previous one for ``--resume auto``
  (:func:`find_latest_valid`); a guard rollback prunes the abandoned newer
  saves (:func:`discard_newer`);
- loads refuse a tree that does not match with JAX's messages: the missing
  and unexpected keys, a shape, or a dtype (master weights and moments are
  fp32 under every precision policy, so no load casts).

The port's own flatten walks dicts, lists, tuples and dataclasses (its
``AdamState``, ``ShardedAdam``, ``AsyncState``): it needs no JAX tree
utility. Leaves may be numpy arrays, Python scalars or tensors on any
device (fetched to the host for a save).

Who writes in a world of several ranks: the trainers gather their shards
on every rank (every rank must enter the gather, or the world deadlocks),
each host's local rank 0 writes (``World.lead``: rank 0 alone on one
host), and every rank meets at a barrier before the next span
(:func:`save_checkpoint_world`). A resume or a rollback reads on every
rank. Across hosts (``parallel/multihost.py``, or torchrun on several
nodes) each host's lead writes to its own ``--checkpoint-dir``, as every
JAX process writes its own, so each host's disk holds the saves its own
resume reads. Two hosts that name one directory (a shared disk) write the
same bytes at the same step at once: every write goes through a temp file
of its own (``mkstemp``) and ``os.replace``, and pruning tolerates a file
the other writer removed first, so the directory keeps one valid newest
save with valid manifests.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import zlib
from typing import Any

import numpy as np

_META_KEY = "__meta__"
MANIFEST_SUFFIX = ".manifest.json"


def _children(node) -> list[tuple[str, Any]] | None:
    """``(key string, child)`` of a tree node in JAX's flatten order, or
    None for a leaf. None is a node without children, as in JAX."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", x) for i, x in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f".{f.name}", getattr(node, f.name)) for f in dataclasses.fields(node)]
    return None


def flatten_with_paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """Every leaf of ``tree`` with its JAX ``keystr`` path, in JAX's
    ``tree_flatten_with_path`` order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [item for key, sub in kids for item in flatten_with_paths(sub, prefix + key)]


def _rebuild(like: Any, it) -> Any:
    """A tree shaped like ``like`` whose leaves, in flatten order, come
    from the iterator ``it``."""
    if like is None:
        return None
    if isinstance(like, dict):
        made = {k: _rebuild(like[k], it) for k in sorted(like)}
        return {k: made[k] for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*[_rebuild(getattr(like, f), it) for f in like._fields])
    if isinstance(like, (list, tuple)):
        out = [_rebuild(x, it) for x in like]
        return out if isinstance(like, list) else tuple(out)
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        made = {f.name: _rebuild(getattr(like, f.name), it) for f in dataclasses.fields(like)}
        return dataclasses.replace(like, **made)
    return next(it)


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array (a tensor is detached and copied to
    the host)."""
    if hasattr(leaf, "detach"):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)


def _dtype(leaf):
    """A leaf's numpy dtype (None for a plain Python value, which JAX does
    not check either)."""
    dt = getattr(leaf, "dtype", None)
    if dt is None:
        return None
    if hasattr(leaf, "detach"):  # a tensor: its dtype as numpy names it
        return np.dtype(str(dt).removeprefix("torch."))
    return np.dtype(dt)


def host_arrays(tree: Any) -> dict[str, np.ndarray]:
    """``{keystr path: host array}`` of a tree: the members a save writes."""
    return {key: _host(leaf) for key, leaf in flatten_with_paths(tree)}


def _crc(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes()) & 0xFFFFFFFF


def _fsync_dir(d: str) -> None:
    """Durability for the rename itself (POSIX: a replace is not durable
    until the DIRECTORY is synced). Best-effort — some filesystems refuse
    O_RDONLY fsync on directories."""
    try:
        fd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass


def _write_json_atomic(path: str, payload: dict) -> None:
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.json")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def manifest_path(path: str | os.PathLike) -> str:
    return os.fspath(path) + MANIFEST_SUFFIX


def _write_npz_atomic(dst: str, arrays: dict[str, np.ndarray],
                      meta: dict) -> None:
    d = os.path.dirname(dst) or "."
    # Suffix must be .npz or np.savez appends one, orphaning the temp path.
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    os.close(fd)  # np.savez owns the file (and its ZipFile finalization)
    try:
        np.savez(tmp, **{_META_KEY: np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8
        )}, **arrays)
        with open(tmp, "rb") as f:  # flush the zip to stable storage
            os.fsync(f.fileno())
        os.replace(tmp, dst)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _drop_same_file_tmp(tmp: str) -> None:
    """After ``os.replace(tmp, dst)`` of a hardlink: when ``dst`` already
    was a link of the same file (another writer of the same save got there
    first), POSIX rename does nothing and leaves ``tmp``; remove it."""
    try:
        os.unlink(tmp)
    except FileNotFoundError:
        pass


def _retained_name(path: str, step: int) -> str:
    stem = path[:-4] if path.endswith(".npz") else path
    return f"{stem}-{step:08d}.npz"


def _retained_files(path: str) -> list[tuple[int, str]]:
    """Existing retained siblings of ``path``, ascending by step."""
    stem = os.path.basename(path[:-4] if path.endswith(".npz") else path)
    d = os.path.dirname(path) or "."
    out = []
    try:
        names = os.listdir(d)
    except FileNotFoundError:
        return []
    for fn in names:
        if not (fn.startswith(stem + "-") and fn.endswith(".npz")):
            continue
        tail = fn[len(stem) + 1:-4]
        if tail.isdigit():
            out.append((int(tail), os.path.join(d, fn)))
    return sorted(out)


def save_checkpoint(
    path: str | os.PathLike,
    tree: Any,
    *,
    step: int | None = None,
    extra: dict | None = None,
    keep: int = 0,
) -> None:
    """Atomically save a pytree (params, optimizer state, ...) to ``path``.

    Tensors on a device are fetched to the host. ``extra`` must be
    JSON-serializable metadata (config echo, accuracy, ...). Every save
    writes a ``<path>.manifest.json`` sidecar (per-array CRC32s — the
    :func:`verify_checkpoint` contract). With ``keep > 0`` and a
    ``step``, the save is ALSO retained as ``<stem>-<step:08d>.npz``
    (``path`` becomes a hardlink of it) and older retained saves beyond
    the newest ``keep`` are pruned — the fallback chain ``--resume
    auto`` walks when the latest file is corrupt.
    """
    path = os.fspath(path)
    arrays = host_arrays(tree)
    meta = {"step": step, "extra": extra or {}}
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    manifest = {
        "schema": "ddl_tpu.ckpt.v1",
        "step": step,
        "arrays": {k: {"crc32": _crc(a), "shape": list(a.shape),
                       "dtype": str(a.dtype)} for k, a in arrays.items()},
    }
    if keep > 0 and step is not None:
        retained = _retained_name(path, step)
        _write_npz_atomic(retained, arrays, meta)
        _write_json_atomic(manifest_path(retained), manifest)
        # Rolling name = hardlink of the newest retained save (same
        # inode, zero extra bytes); fall back to an independent write on
        # filesystems without hardlinks.
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
        os.close(fd)
        os.unlink(tmp)
        try:
            os.link(retained, tmp)
            os.replace(tmp, path)
            _drop_same_file_tmp(tmp)
        except OSError:
            if os.path.exists(tmp):
                os.unlink(tmp)
            _write_npz_atomic(path, arrays, meta)
        _write_json_atomic(manifest_path(path), manifest)
        for _, old in _retained_files(path)[:-keep]:
            for victim in (old, manifest_path(old)):
                try:
                    os.unlink(victim)
                except FileNotFoundError:
                    pass
    else:
        _write_npz_atomic(path, arrays, meta)
        _write_json_atomic(manifest_path(path), manifest)
    _fsync_dir(d)


def verify_checkpoint(path: str | os.PathLike) -> bool:
    """True iff ``path`` is a readable checkpoint whose contents match
    its manifest (per-array CRC32 + the exact array name set). Without a
    manifest (an older save), falls back to a full decompression
    read — which still catches truncation, since the zip directory lives
    at the END of the file. Never raises."""
    path = os.fspath(path)
    man = manifest_path(path)
    try:
        if os.path.exists(man):
            with open(man) as f:
                m = json.load(f)
            want = m.get("arrays", {})
            with np.load(path) as data:
                names = [k for k in data.files if k != _META_KEY]
                if set(names) != set(want):
                    return False
                for name in names:
                    if _crc(data[name]) != int(want[name]["crc32"]):
                        return False
                json.loads(bytes(data[_META_KEY]).decode())
            return True
        with np.load(path) as data:
            json.loads(bytes(data[_META_KEY]).decode())
            for name in data.files:
                data[name]  # force decompression of every member
        return True
    except Exception:  # noqa: BLE001 — any unreadable byte means corrupt
        return False


def checkpoint_step(path: str | os.PathLike) -> int | None:
    """Best-effort step of a checkpoint: the manifest's (cheap), else the
    in-file meta, else None. Never raises."""
    path = os.fspath(path)
    try:
        with open(manifest_path(path)) as f:
            s = json.load(f).get("step")
            return int(s) if s is not None else None
    except Exception:  # noqa: BLE001
        pass
    try:
        with np.load(path) as data:
            s = json.loads(bytes(data[_META_KEY]).decode()).get("step")
            return int(s) if s is not None else None
    except Exception:  # noqa: BLE001
        return None


def find_latest_valid(
    checkpoint_dir: str | os.PathLike,
    *,
    prefix: str = "ckpt",
    max_step: int | None = None,
    log=None,
) -> tuple[str, int] | None:
    """Newest intact checkpoint under ``checkpoint_dir`` as
    ``(path, step)`` — the ``--resume auto`` discovery. Candidates are
    every ``<prefix>*.npz`` (the rolling file and its retained
    siblings), ordered newest-step first; corrupt or truncated files are
    verified out (and reported through ``log``), so one torn save falls
    back to the previous one instead of bricking the resume.
    ``max_step`` bounds the search — the guard's rollback uses it to
    land BEFORE a divergence streak. Returns None when nothing valid
    exists."""
    d = os.fspath(checkpoint_dir)
    try:
        names = os.listdir(d)
    except FileNotFoundError:
        return None
    cands = []
    for fn in names:
        if not (fn.startswith(prefix) and fn.endswith(".npz")):
            continue
        p = os.path.join(d, fn)
        step = checkpoint_step(p)
        cands.append((step if step is not None else -1, fn, p))
    for step, _, p in sorted(cands, reverse=True):
        if max_step is not None and step > max_step:
            continue
        if verify_checkpoint(p):
            return p, max(step, 0)
        if log is not None:
            log(f"[resume] skipping corrupt/unverifiable checkpoint {p}")
    return None


def discard_newer(
    checkpoint_dir: str | os.PathLike,
    step: int,
    *,
    prefix: str = "ckpt",
    log=None,
) -> None:
    """Remove every retained save NEWER than ``step`` and re-point the
    rolling file at the newest survivor — the guard's rollback calls
    this so the abandoned timeline cannot resurface. Without it, a
    crash between rollback and the replay overtaking the pruned steps
    would let ``--resume auto`` pick a stale higher-step file whose
    params never saw the replayed batches (silently lost updates)."""
    d = os.fspath(checkpoint_dir)
    rolling = os.path.join(d, prefix + ".npz")
    for s, p in _retained_files(rolling):
        if s > step:
            for victim in (p, manifest_path(p)):
                try:
                    os.unlink(victim)
                except FileNotFoundError:
                    pass
            if log is not None:
                log(f"[guard] discarded post-rollback checkpoint {p}")
    r_step = checkpoint_step(rolling)
    if not os.path.exists(rolling) or r_step is None or r_step <= step:
        return
    survivors = _retained_files(rolling)
    if survivors:
        # Hardlink the newest surviving retained save over the rolling
        # name (atomic), so plain --resume agrees with --resume auto.
        newest = survivors[-1][1]
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
        os.close(fd)
        os.unlink(tmp)
        try:
            os.link(newest, tmp)
            os.replace(tmp, rolling)
            _drop_same_file_tmp(tmp)
            man = manifest_path(newest)
            if os.path.exists(man):
                with open(man) as f:
                    _write_json_atomic(manifest_path(rolling), json.load(f))
        except OSError:
            if os.path.exists(tmp):
                os.unlink(tmp)
    else:
        for victim in (rolling, manifest_path(rolling)):
            try:
                os.unlink(victim)
            except FileNotFoundError:
                pass
    _fsync_dir(d)


def _read_tree(data, path, like: Any, prefix: str = "") -> Any:
    """Rebuild ``like``'s structure from an open ``.npz``, reading each
    leaf at ``prefix + keystr(leaf_path)``: the one flatten/key/shape/dtype
    check loop behind both full and subtree loads. Extra keys in the file
    are never read, unless expected keys are missing: then the error names
    both the path-qualified missing leaves and the file's unexpected keys
    (the usual cause: a tree from another strategy family or model
    config)."""
    flat = flatten_with_paths(like, prefix)
    expected = [k for k, _ in flat]
    missing = [k for k in expected if k not in data]
    if missing:
        known = set(expected) | {_META_KEY}
        unexpected = sorted(k for k in data.files if k not in known)

        def _fmt(keys):
            shown = ", ".join(keys[:8])
            more = f", ... ({len(keys) - 8} more)" if len(keys) > 8 else ""
            return f"[{shown}{more}]"

        raise KeyError(
            f"checkpoint {path} does not match the expected tree: "
            f"{len(missing)} missing leaves {_fmt(missing)}; "
            f"{len(unexpected)} unexpected keys in the file "
            f"{_fmt(unexpected)}"
        )
    leaves = []
    for key, leaf in flat:
        saved = data[key]
        want = _shape(leaf)
        if tuple(saved.shape) != tuple(want):
            raise ValueError(
                f"checkpoint leaf {key} has shape {saved.shape}, "
                f"expected {want}"
            )
        # The dtype must match the template exactly: master weights and
        # Adam moments are fp32 under every precision policy, so a
        # disagreement means the save came from another program, and a
        # silent cast would launder it into a state that trains
        # differently.
        want_dtype = _dtype(leaf)
        if want_dtype is not None and saved.dtype != want_dtype:
            raise ValueError(
                f"checkpoint leaf {key} has dtype {saved.dtype}, "
                f"expected {want_dtype} — precision policies "
                "keep master state fp32; re-export the checkpoint "
                "rather than casting on load"
            )
        leaves.append(saved)
    return _rebuild(like, iter(leaves))


def load_params(
    path: str | os.PathLike, like: Any, *, root: str = "params"
) -> tuple[Any, int | None, dict]:
    """Load ONLY the params subtree of a checkpoint: the serving path,
    which must not require optimizer or step state (a params-only export,
    a foreign trainer's save, or a trimmed file all load; extra leaves are
    ignored).

    ``like`` is the params-shaped template (numpy zeros or tensors; only
    shapes and dtypes are read). Accepts both layouts the trainers write:
    ``{root: params, ...}`` and a bare params-only file. Returns
    ``(params, step, extra)`` like :func:`load_checkpoint`.
    """
    prefix = f"['{root}']"
    with np.load(path) as data:
        meta = json.loads(bytes(data[_META_KEY]).decode())
        nested = any(k.startswith(prefix) for k in data.files)
        tree = _read_tree(data, path, like, prefix if nested else "")
    return tree, meta.get("step"), meta.get("extra", {})


def load_checkpoint(
    path: str | os.PathLike, like: Any
) -> tuple[Any, int | None, dict]:
    """Load a checkpoint into the structure of ``like``.

    Returns ``(tree, step, extra)`` with numpy leaves; the caller places
    them on its devices and shards.
    """
    with np.load(path) as data:
        meta = json.loads(bytes(data[_META_KEY]).decode())
        tree = _read_tree(data, path, like)
    return tree, meta.get("step"), meta.get("extra", {})


def save_checkpoint_world(path, tree: Any, *, world=None, **kw) -> None:
    """:func:`save_checkpoint` in a world of ranks (``world`` a
    ``parallel.mesh.World``; None or a world of one writes at once): each
    host's local rank 0 (``World.lead``) writes ``tree`` (which every rank
    has gathered), then every rank
    meets at a barrier, so no rank starts its next span, or reads the
    directory, before the save is whole."""
    lead, size = (True, 1) if world is None else (world.lead, world.size)
    if lead:
        save_checkpoint(path, tree, **kw)
    if size > 1:
        import torch.distributed as dist

        dist.barrier()
