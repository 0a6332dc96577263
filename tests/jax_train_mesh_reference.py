"""The JAX package's sharded training step and expert-parallel MoE on
meshes of several host devices, for ``tests/test_torch_train_mesh.py``.

Run as its own process (the device count is fixed at JAX's first
import): ``python jax_train_mesh_reference.py cases.pkl out.pkl`` with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` and
``JAX_PLATFORMS=cpu``.  Meshes are built with ``AxisType.Auto`` axes, on
which the reference's ``launch/train.build`` and ``models/moe._moe_ep``
run (its Explicit-axes default fails in the embedding gather).  Every
input and output is numpy.

  steps: name -> (arch, cfg overrides, mesh shape, microbatches,
         compression, lr, params in the JAX layout, [batch, ...]) ->
         {"loss", "grad_norm": [per step], "first": {"params", "m", "v"}
         after the first step}
  moe:   name -> (arch, cfg overrides, mesh shape, layer params, x2) ->
         {"ref": ``moe_apply`` under ``activation_sharding``,
          "composed": the same shards dispatched, computed and combined
          with the reference's own pieces, each pair by its own expert,
          "drops": [each shard's dropped (token, choice) flat indices]}
"""
import dataclasses
import math
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType

from repro import configs
from repro.launch import train as jtrain
from repro.launch.steps import TrainOptions
from repro.models import moe
from repro.models.layers import activation
from repro.optim import AdamWConfig, adamw_init
from repro.parallel.policy import activation_sharding


def cfg_of(arch, over):
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype=jnp.float32)
    if "moe" in over:
        over = dict(over, moe=dataclasses.replace(cfg.moe, **over["moe"]))
    return dataclasses.replace(cfg, **over)


def mesh_of(shape):
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * len(shape))


def run_step(arch, over, shape, mb, compress, lr, params, batches):
    cfg = cfg_of(arch, over)
    mesh = mesh_of(shape)
    ocfg = AdamWConfig(lr=lr)
    out = {"loss": [], "grad_norm": []}
    with activation_sharding(mesh):
        step, p_sh, o_sh = jtrain.build(cfg, mesh, ocfg, TrainOptions(
            microbatches=mb, grad_compression=compress))
        p = jax.tree.map(jnp.asarray, params)
        o = adamw_init(p, ocfg)
        for b in batches:
            # a step's outputs come back in the layouts GSPMD chose, which
            # the jitted step refuses as committed inputs: put them back
            # on the build's shardings
            p, o = jax.device_put(p, p_sh), jax.device_put(o, o_sh)
            p, o, m = step(p, o, {k: jnp.asarray(v) for k, v in b.items()})
            out["loss"].append(float(m["loss"]))
            out["grad_norm"].append(float(m["grad_norm"]))
            if "first" not in out:
                out["first"] = jax.tree.map(np.asarray, {
                    "params": p, "m": o["m"], "v": o["v"]})
    return out


def composed(p, x2, cfg, n):
    """Each of ``n`` shards' tokens routed, dispatched with its own
    capacity by the reference's ``_dispatch_local``, each expert's buffer
    through that expert, combined by ``_combine_local``."""
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    outs, drops = [], []
    for xs in np.split(x2, n):
        xs = jnp.asarray(xs)
        probs = jax.nn.softmax(xs.astype(jnp.float32) @ p["router"].T, -1)
        tw, te = jax.lax.top_k(probs, k)
        tw = tw / jnp.sum(tw, -1, keepdims=True)
        C = max(8, int(math.ceil(xs.shape[0] * k * 1.25 / E)))
        buf, meta = moe._dispatch_local(xs, te, tw, E, k, C)
        up = jnp.einsum("ecd,edf->ecf", buf, p["we_up"])
        h = activation(cfg.act, jnp.einsum("ecd,edf->ecf", buf,
                                           p["we_gate"])) * up \
            if cfg.glu else activation(cfg.act, up)
        y = jnp.einsum("ecf,efd->ecd", h, p["we_down"])
        outs.append(np.asarray(moe._combine_local(y, meta, tw, xs.shape[0], k)))
        drops.append(np.nonzero(~np.asarray(meta[3]))[0])
    return np.concatenate(outs), drops


def run_moe(arch, over, shape, params, x2):
    cfg = cfg_of(arch, over)
    p = jax.tree.map(jnp.asarray, params)
    with activation_sharding(mesh_of(shape)):
        ref = np.asarray(jax.jit(lambda a: moe.moe_apply(p, a, cfg))(x2))
    comp, drops = composed(p, x2, cfg, shape[0])
    return {"ref": ref, "composed": comp, "drops": drops}


def main(cases_path, out_path):
    with open(cases_path, "rb") as f:
        cases = pickle.load(f)
    out = {"steps": {n: run_step(*c) for n, c in cases["steps"].items()},
           "moe": {n: run_moe(*c) for n, c in cases["moe"].items()}}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(*sys.argv[1:3])
