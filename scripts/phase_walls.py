#!/usr/bin/env python3
"""Seconds of some of ``chip_smoke.py``'s phases of one checkout, on one
card: phase 14 (the recurrent families, with phase 18(a)'s 1x1-mesh
serves inside it) and phase 19 (speculation and the fleet on meshes) by
default, or phase 15 (the moe and encdec families), 12 (the fleet),
16(c) (the training driver) and 20 (the training mesh).

    python3 scripts/phase_walls.py ROOT LABEL [PHASES]

``ROOT`` is a checkout (this one, or another commit unpacked with ``git
archive`` into a gitignored directory); its ``chip_smoke.py`` and
``src/`` are imported, its kernels built into this checkout's
``build/kernels/`` (shared between checkouts whose sources agree).
``PHASES`` is a comma-separated subset of ``14,15,19,12,16c,20`` (default
``14,19``); a phase the checkout does not have is skipped.  The phase
functions run as the script runs them (phase 12 on phase 4's params,
phase 19(a) after phase 11(c)'s serve, which it is held against), and
the line ``CUTS {...}`` gives their seconds (and phase 14's depths, the
training driver's depth and its checkpoint's GB).  Two checkouts are
compared inside one call, in the order parent, change, change, parent.
"""
import gc
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(sys.argv[1]).resolve()
SHARED = pathlib.Path(__file__).resolve().parents[1] / "build" / "kernels"
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def _free(torch):
    gc.collect()
    torch.cuda.empty_cache()


def main():
    import torch
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_serving_mesh
    phases = (sys.argv[3] if len(sys.argv) > 3 else "14,19").split(",")
    build.BUILD_DIR = SHARED
    build.build(verbose=False)
    build.library()
    smi = cs.nvidia_smi_line()
    out = {"label": sys.argv[2], "device": smi}
    quiet = lambda m: None  # noqa: E731
    mesh = make_serving_mesh("1x1", "cuda")
    if "14" in phases:
        t0 = time.perf_counter()
        cs.recurrent_phase(torch, quiet, smi, mesh)
        out["14"] = time.perf_counter() - t0
        out["14_layers"] = getattr(cs, "RECURRENT_LAYERS", {})
        _free(torch)
    if "19" in phases and hasattr(cs, "mesh_spec_phase"):
        cfg, params, _ = cs.build_model(torch, quiet)
        ref, _ = cs.spec_cli(torch, quiet, cfg, "(c)")
        t0 = time.perf_counter()
        cs.mesh_spec_phase(torch, quiet, cfg, mesh, ref)
        out["19a"] = time.perf_counter() - t0
        del params
        _free(torch)
        t0 = time.perf_counter()
        cs.mesh_fleet_phase(torch, quiet)
        out["19b"] = time.perf_counter() - t0
        _free(torch)
    if "15" in phases:
        t0 = time.perf_counter()
        cs.moe_encdec_phase(torch, quiet, smi, mesh)
        out["15"] = time.perf_counter() - t0
        out["15_layers"] = dict(cs.MOE_ARCHS)
        _free(torch)
    if "12" in phases:
        cfg, params, _ = cs.build_model(torch, quiet)
        t0 = time.perf_counter()
        cs.fleet_phase(torch, quiet, cfg, params)
        out["12"] = time.perf_counter() - t0
        del params
        _free(torch)
    if "16c" in phases:
        t0 = time.perf_counter()
        res = cs.driver_phase(torch, quiet)
        out["16c"] = time.perf_counter() - t0
        out["16c_layers"] = res["layers"]
        out["16c_checkpoint_gb"] = res["checkpoint_gb"]
    if "20" in phases and hasattr(cs, "train_mesh_phase"):
        t0 = time.perf_counter()
        res = cs.train_mesh_phase(torch, quiet, mesh)
        out["20"] = time.perf_counter() - t0
        out["20_parts"] = res["seconds"]
        _free(torch)
    import torch.distributed as dist
    dist.destroy_process_group()
    print("CUTS " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
