"""Batched serving with compressed 8:16 weights (port of
``examples/serve_sparse.py``): swaps every projection for its compressed
``SparseWeight`` form and serves a batch of prompts through the port's
serve CLI, on the card through the hand-written kernels.

    PYTHONPATH=src python examples/torch/serve_sparse.py --arch llama-paper
    PYTHONPATH=src python examples/torch/serve_sparse.py \\
        --arch internlm2-1.8b --device cpu

Any arch id of ``repro_torch.configs.get_smoke`` works; the smoke-sized
variants keep it CPU-friendly.
"""
import argparse

from repro_torch.launch.serve import main as serve_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--dense", action="store_true",
                    help="serve dense weights instead (for comparison)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    serve_argv = ["--arch", args.arch, "--smoke-arch",
                  "--batch", str(args.batch),
                  "--prompt-len", str(args.prompt_len),
                  "--gen", str(args.gen), "--device", args.device]
    if not args.dense:
        serve_argv.append("--sparse")
    return serve_main(serve_argv)


if __name__ == "__main__":
    main()
