"""Checkpoints in the JAX package's on-disk layout (port of
``repro/runtime/checkpoint.py``), so a checkpoint crosses both ways.

Layout (one directory per step):
    ckpt_dir/
      step_000120.tmp/ ... -> renamed to step_000120/ once written
        manifest.json        # step, time, config hash, process count,
                             # each leaf's global shape and dtype
        shard_00000.npz      # the leaves, by name

Leaves are named and shaped as the JAX package's pytree paths over its
stacked tree: the port's per-layer lists are stacked [L, ...]
(``interchange.to_jax_layout``), so the port's ``params["layers"][i]["wq"]``
is row i of ``params/layers/wq``, and an AdamW state's moments sit under
``opt/m/...`` and ``opt/v/...`` beside ``opt/step``.  Dict keys are walked
sorted, as ``jax.tree_util`` walks them.  ``np.savez`` takes no bfloat16:
a bf16 leaf is stored as its 16-bit pattern (uint16), and the manifest's
dtype string (``bfloat16``, ``float32``, ``int32``: numpy's names, as the
reference writes them) says how to read it back.

``save`` copies every leaf to host memory on the caller's thread (on the
CPU a tensor's ``numpy()`` shares its memory, and the caller goes on
updating its state), then writes, blocking or in a background thread that
``wait`` joins; the commit is an atomic rename, so a crashed save leaves
only a ``.tmp`` directory that ``gc_stale_tmp`` removes.  ``restore(like)``
reads the leaves ``like``'s structure names, checks each global shape
against the manifest and ``like``'s, and returns the port's per-layer lists on the
device of ``like``'s leaves.

On a training mesh (the manager's ``shardings``: a
``parallel.fsdp.StateSharding``; ``restore`` also takes one a call) the
tree holds each rank's blocks.
``save`` gathers each leaf to its global shape in turn, with every rank
taking part, on the caller's thread (collectives go in one order on
every rank); the mesh's first rank alone copies it to the host, and
writes, so the file is the one an unplaced save of the same values
writes.  ``wait``
joins the write and then holds every rank at a barrier, and
``latest_step`` is the first rank's answer, broadcast: no rank restores
a step the writer has not committed.  ``restore`` reads the global
arrays on every rank, checks them against the manifest's and the specs'
global shapes, and keeps the rank's block of each by its spec.  So a
checkpoint crosses between meshes of any shape, the unplaced port and
the JAX package.
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import shutil
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from ..interchange import STACKED, from_jax_layout, to_jax_layout
from ..parallel.sharding import local_shard
from ..tree import flatten, unflatten

def _jax_items(tree, prefix=()):
    """(path, leaf) of ``tree`` in the JAX package's stacked layout and
    flatten order: dict keys sorted, a ``STACKED`` per-layer list as one
    dict whose leaves are the lists of their layers' tensors (nothing is
    stacked here)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            v = tree[k]
            if k in STACKED and isinstance(v, list):
                v = to_jax_layout({k: v}, stack=list)[k]
            yield from _jax_items(v, prefix + (str(k),))
    else:
        yield prefix, tree


def _gathered(items, sh):
    """``items`` (``_jax_items`` of a tree of this rank's blocks) with each
    leaf gathered to its global shape, one leaf at a time: every rank
    takes part, and only one leaf's whole layers are alive at once."""
    from ..parallel.tensor_parallel import all_gather_leaf
    tm = sh.tm
    for (path, leaf), (_, spec), (_, shape) in zip(
            items, _jax_items(sh.specs), _jax_items(sh.shapes)):
        if isinstance(leaf, list):
            yield path, [all_gather_leaf(t, tm, sp, sz)
                         for t, sp, sz in zip(leaf, spec, shape)]
        else:
            yield path, all_gather_leaf(leaf, tm, spec, shape)


def _leaf_names(tree) -> list[str]:
    """The reference's leaf names ("params/layers/wq") of ``tree``."""
    return ["/".join(path) for path, _ in _jax_items(tree)]


def config_hash(cfg) -> str:
    """The first 12 hex digits of the SHA-1 of ``repr(cfg)``."""
    return hashlib.sha1(repr(cfg).encode()).hexdigest()[:12]


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _host(t: torch.Tensor, copy: bool = True) -> np.ndarray:
    """``t`` in host memory, bf16 as its uint16 bit pattern; with ``copy``
    a copy that no later in-place update of ``t`` reaches (on the CPU
    ``numpy()`` shares the tensor's memory)."""
    t = t.detach()
    bf16 = t.dtype == torch.bfloat16
    a = (t.view(torch.int16) if bf16 else t).cpu().numpy()
    if bf16:
        a = a.view(np.uint16)
    return a.copy() if copy and t.device.type == "cpu" else a


def _host_leaf(leaf) -> tuple[np.ndarray, str]:
    """(host copy, manifest dtype) of one leaf: a tensor, or the list of
    its layers' tensors as one [L, ...] array, each layer copied straight
    into its row."""
    if not isinstance(leaf, list):
        return _host(leaf), _dtype_name(leaf)
    first = leaf[0].detach()
    bf16 = first.dtype == torch.bfloat16
    dtype = np.uint16 if bf16 else torch.empty(0, dtype=first.dtype
                                               ).numpy().dtype
    out = np.empty((len(leaf), *first.shape), dtype)
    rows = torch.from_numpy(out.view(np.int16) if bf16 else out)
    for i, t in enumerate(leaf):
        t = t.detach()
        rows[i].copy_(t.view(torch.int16) if bf16 else t)
    return out, _dtype_name(first)


def _global_shape(leaf) -> tuple:
    """A leaf's shape in the stacked layout."""
    if isinstance(leaf, list):
        return (len(leaf), *leaf[0].shape)
    return tuple(leaf.shape)


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A stored array as a CPU tensor of the manifest's ``dtype``."""
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr.view(np.dtype(dtype)))


def _nest(flat: dict) -> dict:
    """{("a", "b"): x} -> {"a": {"b": x}}."""
    out = {}
    for path, v in flat.items():
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


def _place(like, tree):
    """``tree``'s leaves moved to the devices of ``like``'s, in ``like``'s
    key order."""
    if isinstance(like, dict):
        return {k: _place(v, tree[k]) for k, v in like.items()}
    if isinstance(like, list):
        return [_place(a, b) for a, b in zip(like, tree)]
    return tree.to(like.device)


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, keep_last_k: int = 3,
                 shardings=None):
        self.dir = pathlib.Path(directory)
        self.shardings = shardings
        self.keep = keep_last_k
        self._thread: threading.Thread | None = None
        if self._writer():
            self.dir.mkdir(parents=True, exist_ok=True)
            self.gc_stale_tmp()

    def _group(self):
        """The mesh's group when the state is sharded over more than one
        rank, else None."""
        return None if self.shardings is None \
            else self.shardings.tm.world_group

    def _writer(self) -> bool:
        sh = self.shardings
        return sh is None or not any(sh.tm.coords.values())

    # ------------------------------------------------------------- save ---
    def save(self, step: int, tree, cfg=None, blocking: bool = True):
        """Write ``tree`` (nested dicts and per-layer lists of tensors) as
        step ``step``.  The host copy is made here; the write runs in the
        background when ``blocking`` is False.  With the manager's
        ``shardings`` ``tree`` holds this rank's blocks, gathered whole
        here by every rank together."""
        self.wait()
        sh = self.shardings
        writer = self._writer()
        host, leaves = {}, {}
        items = _jax_items(tree)
        if sh is not None:
            items = _gathered(items, sh)
        for path, leaf in items:
            if not writer:
                continue
            name = "/".join(path)
            host[name], dtype = _host_leaf(leaf)
            leaves[name] = {"shape": list(host[name].shape), "dtype": dtype}
        if not writer:
            return
        manifest = {
            "step": step,
            "time": time.time(),
            "config_hash": config_hash(cfg) if cfg is not None else None,
            "process_count": 1,
            "leaves": leaves,
        }

        def _write():
            tmp = self.dir / f"step_{step:06d}.tmp"
            final = self.dir / f"step_{step:06d}"
            tmp.mkdir(parents=True, exist_ok=True)
            np.savez(tmp / "shard_00000.npz", **host)
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            os.replace(tmp, final)          # atomic commit
            self._gc()

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self):
        """Join the background write; on a mesh, then a barrier of every
        rank, so the write is committed for all of them."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._group() is not None:
            dist.barrier(group=self._group())

    # ---------------------------------------------------------- restore ---
    def latest_step(self) -> int | None:
        """The newest committed step (on a mesh, the writer's answer on
        every rank)."""
        steps = sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                       if not p.name.endswith(".tmp"))
        latest = [steps[-1] if steps else None]
        group = self._group()
        if group is not None:
            dist.broadcast_object_list(
                latest, src=dist.get_process_group_ranks(group)[0],
                group=group)
        return latest[0]

    def restore(self, like, step: int | None = None, shardings=None):
        """(tree shaped like ``like``, manifest) of step ``step`` (the
        latest by default), each leaf on the device of ``like``'s.  With
        ``shardings`` (or the manager's) ``like`` holds this rank's
        blocks: each leaf is checked at its global shape and cut to the
        rank's block by its spec."""
        sh = shardings if shardings is not None else self.shardings
        if sh is not None:
            blocks = like
            like = unflatten(like, [
                torch.empty(shape, device="meta")
                for shape in flatten(sh.shapes)])
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = self.dir / f"step_{step:06d}"
        manifest = json.loads((d / "manifest.json").read_text())
        data = {}
        for shard in sorted(d.glob("shard_*.npz")):
            with np.load(shard) as z:
                data.update({k: z[k] for k in z.files})
        flat = {}
        for path, leaf in _jax_items(like):
            name = "/".join(path)
            arr, meta = data[name], manifest["leaves"][name]
            for expect in (tuple(meta["shape"]), _global_shape(leaf)):
                if tuple(arr.shape) != expect:
                    raise ValueError(f"shape mismatch for {name}: "
                                     f"{arr.shape} vs {expect}")
            flat[path] = _to_tensor(arr, meta["dtype"])
        # split the [L, ...] leaves on the host, then move each piece
        whole = from_jax_layout(_nest(flat))
        if sh is None:
            return _place(like, whole), manifest
        tm = sh.tm
        out = []
        for t, spec, block in zip(flatten(whole),
                                  flatten(sh.specs), flatten(blocks)):
            t = local_shard(t, spec, tm.sizes, tm.coords)
            if tuple(t.shape) != tuple(block.shape):
                raise ValueError(f"block shape mismatch: {tuple(t.shape)} "
                                 f"vs {tuple(block.shape)}")
            out.append(t.contiguous().to(block.device))
        return unflatten(blocks, out), manifest

    # --------------------------------------------------------------- gc ---
    def _gc(self):
        steps = sorted((int(p.name.split("_")[1]), p) for p in self.dir.glob("step_*")
                       if not p.name.endswith(".tmp"))
        for _, p in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(p, ignore_errors=True)

    def gc_stale_tmp(self):
        for p in self.dir.glob("*.tmp"):
            shutil.rmtree(p, ignore_errors=True)
