#!/usr/bin/env python3
"""Seconds of ``chip_smoke.py``'s phase 12 (the fleet) and phase 16(c)
(the training driver) of one checkout, on one card.

    python3 scripts/phase_walls.py ROOT LABEL

``ROOT`` is a checkout (this one, or another commit unpacked with ``git
archive`` into a gitignored directory); its ``chip_smoke.py`` and
``src/`` are imported, its kernels built into this checkout's
``build/kernels/`` (shared between checkouts whose sources agree).  The
phase functions run as the script runs them, on phase 4's params for
phase 12, and the line ``CUTS {...}`` gives their seconds, the training
driver's depth and its checkpoint's GB.  Two checkouts are compared inside one
call, in the order parent, change, change, parent.
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


def main():
    import torch
    from repro_torch.kernels import build
    build.BUILD_DIR = SHARED
    build.build(verbose=False)
    build.library()
    out = {"label": sys.argv[2], "device": cs.nvidia_smi_line()}
    cfg, params, _ = cs.build_model(torch, lambda m: None)
    t0 = time.perf_counter()
    cs.fleet_phase(torch, lambda m: None, cfg, params)
    out["12"] = time.perf_counter() - t0
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = cs.driver_phase(torch, lambda m: None)
    out["16c"] = time.perf_counter() - t0
    out["16c_layers"] = res["layers"]
    out["16c_checkpoint_gb"] = res["checkpoint_gb"]
    print("CUTS " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
