"""Step functions: train, prefill, decode (port of
``repro/launch/steps.py``).

``make_train_step(cfg, opt_cfg, opts)`` returns ``train_step(params,
opt_state, batch) -> (params, opt_state, {"loss", "grad_norm"})``: the
gradient of the family's loss (``models.model_zoo.get_model(cfg).loss``,
so every family trains) through ``torch.autograd``, then one
``optim.adamw_step``.  With ``microbatches > 1`` the batch is split along
axis 0 into contiguous chunks (microbatch i holds rows i*B/mb ..
(i+1)*B/mb, as the reference's reshape groups them); the gradients are
summed in f32 and divided by ``mb``, and the loss is the mean over the
microbatches.  With ``grad_compression`` each microbatch's gradients go
through ``grad_compress.compress_with_feedback`` and ``decompress`` from a
zero error, as in the reference, which drops the error every microbatch;
each per-layer leaf is stacked [L, ...] first
(``interchange.to_jax_layout``), so its layers share one absmax scale, as
the reference's stacked leaves do.

As in the reference, M-RoPE positions [3, B, S] split along axis 1.
``make_prefill_step`` and ``make_decode_step`` wrap the zoo's ``prefill``
and ``decode``; the port has no layer scan, so ``unroll`` (the
reference's dry-run switch) changes nothing.

With ``sharding`` (``launch/train.build(mesh=)``) the step is the
reference's sharded one: see ``parallel/fsdp.py``.  A microbatch's
gradient arrives reduced over the data shards (the gather's backward), so
compression quantizes the global gradient, each leaf by its whole absmax.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from ..interchange import from_jax_layout, to_jax_layout
from ..models.model_zoo import get_model
from ..optim import AdamWConfig, adamw_step
from ..optim import grad_compress as gc
from ..parallel.fsdp import gather_tree
from ..parallel.policy import activation_sharding
from ..parallel.sharding import batch_spec, local_shard, splits
from ..tree import flatten, unflatten, value_and_grad


def _int8_round_trip(grads, all_max=None):
    """One microbatch's gradients through ``compress_with_feedback`` from a
    zero error and back, every per-layer list stacked [L, ...] as the
    reference keeps it, so each leaf's L layers share one absmax scale
    (on a mesh, ``all_max``: the whole leaf's over its blocks)."""
    stacked = to_jax_layout(grads)
    q, _ = gc.compress_with_feedback(stacked, gc.init_error(stacked),
                                     all_max)
    return from_jax_layout(gc.decompress(q, stacked))


def _all_max(tm, spec):
    """A block's absmax -> its whole leaf's: a max over the ranks holding
    the leaf's other blocks (none when ``spec`` splits nothing)."""
    group, _ = tm.group_for(spec)
    if group is None:
        return None

    def reduce(a):
        a = a.clone()
        torch.distributed.all_reduce(a, op=torch.distributed.ReduceOp.MAX,
                                     group=group)
        return a
    return reduce


def _rows(batch, tm):
    """This rank's rows of a global batch, by ``batch_spec`` (M-RoPE
    positions [3, B, S] on axis 1); every data shard must get rows of its
    own."""
    out = {}
    for k, v in batch.items():
        spec = batch_spec(tm.mesh, v.shape)
        if tm.n_fsdp > 1 and not splits(spec):
            raise ValueError(
                f"batch entry {k!r} {tuple(v.shape)}: its rows do not split "
                f"over {tm.n_fsdp} data shards")
        out[k] = local_shard(v, spec, tm.sizes, tm.coords)
    return out


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    microbatches: int = 1          # gradient accumulation steps
    grad_compression: bool = False # int8 per microbatch (error dropped)
    unroll: bool = False           # kept for the reference's name: the
                                   # port's layer loop is always Python


def make_train_step(cfg, opt_cfg: AdamWConfig,
                    opts: TrainOptions = TrainOptions(), sharding=None):
    """The step; with ``sharding`` (``parallel.fsdp.StateSharding`` of the
    params) it takes and returns this rank's blocks of the params and
    moments and the global batch, runs under ``activation_sharding`` on
    the sharding's mesh, and computes on the rank's rows of each
    microbatch (the reference's contiguous microbatches, each cut by
    ``batch_spec``) with every leaf gathered whole."""
    zoo = get_model(cfg)
    if sharding is None:
        def loss_of(params, batch):
            return zoo.loss(params, batch)[0]
        policy = contextlib.nullcontext
        all_max = rows = None
    else:
        tm = sharding.tm

        def loss_of(blocks, batch):
            return zoo.loss(gather_tree(blocks, sharding), batch)[0]

        def policy():
            return activation_sharding(tm)

        def rows(part):
            return _rows(part, tm)
        stacked = flatten(to_jax_layout(sharding.specs,
                                        stack=lambda specs: specs[0]))
        all_max = [_all_max(tm, spec) for spec in stacked]

    def train_step(params, opt_state, batch):
        with policy():
            return _step(params, opt_state, batch)

    def _step(params, opt_state, batch):
        mb = opts.microbatches
        if mb > 1:
            # the batch axis is axis 0 except for M-RoPE positions [3, B, S]
            bdim = max(v.shape[0] for v in batch.values() if v.shape[0] != 3)

            def part_of(v, i):
                ax = 0 if v.shape[0] == bdim else 1
                return v.reshape(*v.shape[:ax], mb, v.shape[ax] // mb,
                                 *v.shape[ax + 1:]).select(ax, i)
            gsum, lsum = None, 0.0
            for i in range(mb):
                part = {k: part_of(v, i) for k, v in batch.items()}
                if rows is not None:
                    part = rows(part)
                loss, grads = value_and_grad(loss_of, params, part)
                if opts.grad_compression:
                    grads = _int8_round_trip(grads, all_max)
                g32 = [g.to(torch.float32) for g in flatten(grads)]
                gsum = g32 if gsum is None else [a + b for a, b in
                                                 zip(gsum, g32)]
                del grads
                lsum = lsum + loss
            grads = unflatten(params, [g / mb for g in gsum])
            del gsum
            loss = lsum / mb
        else:
            loss, grads = value_and_grad(
                loss_of, params, batch if rows is None else rows(batch))
        new_params, new_opt, metrics = adamw_step(params, grads, opt_state,
                                                  opt_cfg, sharding=sharding)
        return new_params, new_opt, {"loss": loss, **metrics}

    return train_step


def make_prefill_step(cfg, unroll: bool = False):
    """``prefill_step(params, batch) -> (last logits [B, V], caches)``."""
    zoo = get_model(cfg)

    def prefill_step(params, batch):
        return zoo.prefill(params, batch)

    return prefill_step


def make_decode_step(cfg, unroll: bool = False):
    """``decode_step(params, caches, {"tokens": [B, 1]}) -> (logits
    [B, V], caches)``, one lock-step token for every row."""
    zoo = get_model(cfg)

    def decode_step(params, caches, batch):
        return zoo.decode(params, caches, batch)

    return decode_step
