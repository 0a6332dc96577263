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
device of ``like``'s leaves.  One process writes shard 0; restoring onto
a mesh (``shardings=``) waits for the training half of placement
(ROADMAP A12c).
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

from ..interchange import STACKED, from_jax_layout, to_jax_layout

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
    def __init__(self, directory: str | os.PathLike, keep_last_k: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep_last_k
        self._thread: threading.Thread | None = None
        self.gc_stale_tmp()

    # ------------------------------------------------------------- save ---
    def save(self, step: int, tree, cfg=None, blocking: bool = True):
        """Write ``tree`` (nested dicts and per-layer lists of tensors) as
        step ``step``.  The host copy is made here; the write runs in the
        background when ``blocking`` is False."""
        self.wait()
        host, leaves = {}, {}
        for path, leaf in _jax_items(tree):
            name = "/".join(path)
            host[name], dtype = _host_leaf(leaf)
            leaves[name] = {"shape": list(host[name].shape), "dtype": dtype}
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
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ---------------------------------------------------------- restore ---
    def latest_step(self) -> int | None:
        steps = sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                       if not p.name.endswith(".tmp"))
        return steps[-1] if steps else None

    def restore(self, like, step: int | None = None, shardings=None):
        """(tree shaped like ``like``, manifest) of step ``step`` (the
        latest by default), each leaf on the device of ``like``'s."""
        if shardings is not None:
            raise NotImplementedError(
                "restore(shardings=...) re-shards onto a training mesh, "
                "which is not ported yet (ROADMAP A12c)")
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
        return _place(like, from_jax_layout(_nest(flat))), manifest

    # --------------------------------------------------------------- gc ---
    def _gc(self):
        steps = sorted((int(p.name.split("_")[1]), p) for p in self.dir.glob("step_*")
                       if not p.name.endswith(".tmp"))
        for _, p in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(p, ignore_errors=True)

    def gc_stale_tmp(self):
        for p in self.dir.glob("*.tmp"):
            shutil.rmtree(p, ignore_errors=True)
