"""Serving driver: a thin CLI over the port's continuous-batching engine
and the one-shot lock-step loop (port of ``repro/launch/serve.py``'s
``build_params``, ``run_oneshot``, ``run_engine``, ``run_trace``,
``--legacy``, the fleet and the observability outputs).

With ``--sparse`` every projection is deployed as an 8:16 (+16:256
outlier) ``SparseWeight`` as soon as its layer is drawn, so a full-size
model never holds all its dense weights at once; on the card each sparse
product runs through the hand-written kernels.  ``--kv-dtype int8`` stores
the KV arenas as int8 with per-position scales, on either layout.

  python -m repro_torch.launch.serve --arch llama3-8b --sparse
  python -m repro_torch.launch.serve --arch gemma-7b --sparse \
      --kv-layout paged --kv-dtype int8
  python -m repro_torch.launch.serve --arch qwen3-8b --smoke-arch \
      --device cpu --batch 2 --prompt-len 16 --gen 4 --sparse
  python -m repro_torch.launch.serve --arch llama-paper --smoke-arch \\
      --device cpu --batch 2 --prompt-len 16 --gen 4 --sparse
  python -m repro_torch.launch.serve --arch llama-paper --smoke-arch \\
      --device cpu --sparse --kv-layout paged --block-size 8
  python -m repro_torch.launch.serve --arch llama-paper --smoke-arch \\
      --device cpu --sparse --kv-layout paged --block-size 8 --kv-dtype int8

``--arch`` takes every registered id (``configs.all_archs()``) and, with
``--smoke-arch``, every id ``configs.get_smoke`` resolves.  Dense ids serve
(qwen3-8b, gemma-7b, internlm2-1.8b, nemotron-4-340b and the paper's
models), and so do mixtral-8x7b and llama4-maverick-400b-a17b (moe: the
routed experts stay dense, the attention and a shared expert compress),
xlstm-350m (ssm: recurrent state slots, any ``--kv-layout`` served as
slot), zamba2-2.7b (hybrid: mamba state slots and the shared attention's
KV, slot or paged, prefix caching off) and whisper-medium (encdec: each
request carries random encoder ``embeds`` [prompt_len, d] drawn from the
run's generator; slot layout only, no ``--trace``); ``--kv-dtype int8``
is refused for ssm, hybrid and encdec.  The engine refuses vlm, as the
reference's does: qwen2-vl-72b serves through the one-shot loop
(``run_oneshot``: one batched ``prefill`` of random ``embeds`` [B, S, d]
drawn from the run's generator at M-RoPE positions ``arange(S)`` on all
three rows, ``grow_caches`` to ``prompt_len + gen``, then greedy lock-step
``decode``).  ``--legacy`` runs that loop for any family and then, for a
greedy engine-served one, the engine on the same prompts: the streams must
be identical at f32 (it exits otherwise), and below f32 the diverging
streams are counted.  ``--max-prefill-per-step N`` is the engine's
request-count spelling of ``--token-budget``:

  python -m repro_torch.launch.serve --arch xlstm-350m --sparse
  python -m repro_torch.launch.serve --arch zamba2-2.7b --smoke-arch \\
      --device cpu --sparse --kv-layout paged --block-size 8
  python -m repro_torch.launch.serve --arch mixtral-8x7b --smoke-arch \\
      --device cpu --sparse --kv-layout paged --block-size 8
  python -m repro_torch.launch.serve --arch whisper-medium --smoke-arch \\
      --device cpu --sparse
  python -m repro_torch.launch.serve --arch qwen2-vl-72b --smoke-arch \\
      --device cpu --sparse
  python -m repro_torch.launch.serve --arch llama-paper --smoke-arch \\
      --device cpu --sparse --legacy

``--draft {ngram,sparse,self}`` turns on draft-verify speculative decoding
(``serving/speculative.py``), ``--spec-k`` drafts a request (each
request's k then adapts to its acceptance).  ``sparse`` drafts with the
8:16 + outlier compression of the target's own dense weights (drawn by
``build_params`` from a generator with the run's seed, as the target is);
``ngram`` by prompt lookup; ``self`` with the target's own params.  Greedy
speculative streams equal the plain ones:

  python -m repro_torch.launch.serve --arch llama-paper --smoke-arch \\
      --device cpu --kv-layout paged --block-size 8 --draft ngram

``--trace t.json`` replays a JSON request trace (``serving/trace.py``,
written by either package's ``save_trace``) open-loop through the engine,
arrival gaps scaled by ``--time-scale``, and prints ``format_summary``'s
line and the requests admission control rejected.  ``--trace-out
out.json`` turns the tracer on (``serving/observe.py``): a Chrome/Perfetto
``trace_event`` JSON of every request lifecycle, engine step, model call
and preemption (load it in ui.perfetto.dev), and a Prometheus counter
snapshot in ``out.json.counters.txt``:

  python -c "from repro_torch.serving import *; save_trace('t.json', \\
      poisson_trace(n_requests=6, rate_per_s=4, vocab=512, \\
      prompt_len=(8, 16), max_new_tokens=6))"
  python -m repro_torch.launch.serve --arch llama-paper --smoke-arch \\
      --device cpu --sparse --kv-layout paged --trace t.json --max-len 32 \\
      --trace-out out.json

``--replicas N`` serves with N engines behind the fleet router
(``serving/fleet/``), each with its own ``--slots``/``--n-blocks`` pool,
all on one card with one copy of the weights; ``--routing`` picks the
policy.  With ``--mesh`` the spec is per replica: N x DATA x MODEL ranks
under ``torchrun``, replica i on ranks [i*DATA*MODEL, (i+1)*DATA*MODEL)
(``make_replica_meshes``), each rank serving its own replica and the
router's numbers gathered across the world.  With ``--trace`` each request's session reaches the router, and
with ``--trace-out`` the replicas' tracks (``r0``..) and the router's
share one file:

  python -m repro_torch.launch.serve --arch llama-paper --smoke-arch \\
      --device cpu --sparse --kv-layout paged --trace t.json --max-len 32 \\
      --replicas 2 --routing prefix --trace-out out.json

``--mesh 1xM`` serves tensor-parallel over M ranks, one process a card
started by ``torchrun`` (``launch/mesh.py``, ``serving/placement.py``):
every rank draws the same params from the run's seed, keeps its out-dim
rows and KV heads, and serves the same requests in lockstep; only rank 0
prints and writes ``--trace-out``.  Every engine-served family is served
so (dense, moe, ssm, hybrid, encdec), ``--draft`` speculates on the
mesh (the drafter on the target's placement), and the one-shot loop
(``--legacy``, the vlm family) is refused: the reference's
``run_oneshot`` takes no mesh either.

  torchrun --nproc-per-node 8 -m repro_torch.launch.serve \\
      --arch llama3-8b --sparse --kv-layout paged --mesh 1x8
  torchrun --nproc-per-node 8 -m repro_torch.launch.serve \\
      --arch llama3-8b --sparse --kv-layout paged --replicas 2 --mesh 1x4
"""
from __future__ import annotations

import argparse
import contextlib
import io
import time

import torch
import torch.distributed as dist

from ..configs import get, get_smoke
from ..core import SparsifyConfig
from ..device import resolve
from ..models import transformer as tfm
from ..models import whisper as whi
from ..models import xlstm as xls
from ..models import zamba as zam
from ..models.model_zoo import grow_caches
from ..models.sparse_serving import sparsify_for_serving
from ..runtime.metrics import format_summary, summarize
from ..serving import (SUPPORTED_FAMILIES, ReplicaSet, RouterTracer,
                       SamplingParams, ServingEngine, ServingTracer,
                       SpeculativeConfig, load_trace, replay)
from .mesh import make_replica_meshes, make_serving_mesh, parse_mesh_spec
from .steps import make_decode_step, make_prefill_step


def build_params(cfg, args, device, generator: torch.Generator, *,
                 quantize: bool = False):
    """Draw the model from ``generator`` one layer at a time, deploying
    compressed weights with ``--sparse`` (int8 N:M values with exact
    outliers when ``quantize``).  Returns (params, report)."""
    report = {"n_layers_sparsified": 0, "dense_bytes": 0,
              "compressed_bytes": 0}
    layer_fn = None
    if args.sparse:
        outlier = None if args.outlier_pattern == "none" \
            else args.outlier_pattern
        # random weights have no calibration statistics: magnitude scores
        # without SmoothQuant, as the JAX package's serve passes them
        scfg = SparsifyConfig(weight_pattern=args.weight_pattern,
                              outlier_pattern=outlier, scorer="magnitude",
                              use_smoothquant=False)

        def layer_fn(lp):
            lp, rep = sparsify_for_serving(lp, scfg, quantize=quantize)
            for key in report:
                report[key] += rep[key]
            return lp
    init = {"ssm": xls.init_params, "hybrid": zam.init_params,
            "encdec": whi.init_params}.get(cfg.family, tfm.init_params)
    params = init(cfg, generator, device, layer_fn=layer_fn)
    report["ratio"] = report["compressed_bytes"] / max(report["dense_bytes"], 1)
    return params, report


def _make_draft(cfg, params, args, device):
    """A SpeculativeConfig from --draft/--spec-k, or None.  ``sparse``
    compresses the dense weights a fresh generator with the run's seed
    draws (the target's own, unless --sparse made the target that
    compression already)."""
    if args.draft == "none":
        return None
    max_k = max(8, args.spec_k)
    if args.draft == "ngram":
        return SpeculativeConfig(k=args.spec_k, max_k=max_k, method="ngram")
    if args.draft == "self":
        dparams = params
    else:
        g = torch.Generator(device=device).manual_seed(args.seed)
        dparams, _ = build_params(
            cfg, argparse.Namespace(**dict(vars(args), sparse=True)), device,
            g)
    return SpeculativeConfig(k=args.spec_k, max_k=max_k, method="model",
                             params=dparams, cfg=cfg)


def _print_spec_stats(engine) -> None:
    sp = engine.stats().get("speculative")
    if sp:
        print(f"  speculative[{sp['method']} k={sp['k']}]: "
              f"acceptance {sp['acceptance_rate']:.2f}, "
              f"{sp['accepted_per_step']:.2f} accepted tok/step "
              f"({sp['accepted']}/{sp['drafted']} over "
              f"{sp['n_spec_steps']} steps)")


def _make_tracer(args):
    """A ServingTracer when --trace-out was given, else None (the engine
    then runs with NULL_TRACER: no observability work per step)."""
    return ServingTracer() if args.trace_out else None


def _make_fleet_tracers(args, n: int):
    """Per-replica ServingTracers sharing ONE buffer and registry (each
    replica gets its own pid pair in the merged Perfetto file) plus the
    RouterTracer of the routing decisions, when --trace-out was given;
    (None, None) otherwise."""
    if not args.trace_out:
        return None, None
    first = ServingTracer(name="r0")
    tracers = [first] + [
        ServingTracer(buffer=first.buffer, registry=first.registry,
                      name=f"r{i}") for i in range(1, n)]
    router = RouterTracer(buffer=first.buffer, registry=first.registry,
                          name="router")
    return tracers, router


def _build_target(cfg, params, args, device, *, max_len: int, mesh=None):
    """The serving target of ``args``: one engine (on ``mesh``, a
    ``DeviceMesh``, when given), or ``--replicas N`` of them behind the
    router (``mesh`` then the list of replica meshes, or None;
    ``ReplicaSet`` takes the engine's surface, so ``run_engine`` and
    ``replay`` drive either).  Returns (target, the tracer whose buffer
    to write, None without --trace-out)."""
    kw = dict(device=device, n_slots=args.slots, max_len=max_len,
              max_queue=args.max_queue, token_budget=args.token_budget,
              max_prefill_per_step=args.max_prefill_per_step,
              kv_layout=args.kv_layout, block_size=args.block_size,
              n_blocks=args.n_blocks,
              prefix_caching=not args.no_prefix_cache,
              kv_dtype=args.kv_dtype,
              draft=_make_draft(cfg, params, args, device))
    if args.replicas == 1:
        tracer = _make_tracer(args)
        if mesh is not None:
            print(f"serving mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))}"
                  f" ({mesh.size()} ranks, {dist.get_backend()})")
        return ServingEngine(cfg, params, tracer=tracer, mesh=mesh,
                             **kw), tracer
    if mesh is not None:
        print(f"fleet meshes: {args.replicas} x "
              f"{dict(zip(mesh[0].mesh_dim_names, mesh[0].shape))} "
              f"(disjoint slices, {dist.get_backend()})")
    tracers, router_tracer = _make_fleet_tracers(args, args.replicas)
    fleet = ReplicaSet(cfg, params, n_replicas=args.replicas,
                       routing=args.routing, meshes=mesh, tracers=tracers,
                       router_tracer=router_tracer, **kw)
    return fleet, (tracers[0] if tracers else None)


def _print_fleet_stats(target) -> None:
    st = target.stats()
    if "n_replicas" not in st:
        return
    pc = st["prefix_cache"]
    per = [f"r{i}: {p['n_finished']} done, {p['n_steps']} steps"
           for i, p in enumerate(st["replicas"])]
    print(f"  fleet[{st['routing']}]: {st['n_replicas']} replicas, "
          f"{st['n_steals']} steals, {st['n_drains']} drains, "
          f"prefix-hit {pc['hit_rate']:.2f} | " + "; ".join(per))


def _write_observability(tracer, args) -> None:
    """Write the Perfetto trace and the Prometheus counter snapshot next
    to it (<trace-out> and <trace-out>.counters.txt)."""
    if tracer is None:
        return
    tracer.write_trace(args.trace_out)
    counters = args.trace_out + ".counters.txt"
    with open(counters, "w") as f:
        f.write(tracer.counters_text())
    print(f"trace written to {args.trace_out} (load in ui.perfetto.dev); "
          f"counters in {counters}")


def draw_inputs(cfg, args, generator: torch.Generator):
    """``--batch`` random prompts [B, prompt_len] drawn from ``generator``
    and, for the vlm and enc-dec families, random ``embeds``
    [B, prompt_len, d] drawn after them (None otherwise)."""
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=generator, device=generator.device)
    embeds = None
    if cfg.family in ("vlm", "encdec"):
        embeds = torch.randn((args.batch, args.prompt_len, cfg.d_model),
                             generator=generator, device=generator.device)
    return prompts, embeds


def oneshot_batch(cfg, prompts, embeds=None) -> dict:
    """The one-shot loop's prefill batch: ``tokens`` [B, S], with an
    enc-dec model's ``embeds`` beside them; a vlm batch is ``embeds`` and
    M-RoPE ``positions`` [3, B, S] = ``arange(S)`` on all three rows, and
    no tokens."""
    batch = {"tokens": prompts}
    if embeds is not None:
        batch["embeds"] = embeds
    if cfg.family == "vlm":
        B, S = prompts.shape
        batch["positions"] = torch.arange(S, device=prompts.device).expand(
            3, B, S)
        del batch["tokens"]
    return batch


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_oneshot(cfg, params, batch: dict, gen: int):
    """The lock-step loop for every family: one batched ``prefill`` of
    ``batch`` (``oneshot_batch``), ``grow_caches`` to hold ``gen`` more
    positions, then ``gen - 1`` greedy ``decode`` steps of the whole batch.
    Returns (tokens [B, gen], {"prefill_s", "decode_s", "tok_per_s"})."""
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    B, S = (batch["tokens"] if "tokens" in batch else batch["embeds"]
            ).shape[:2]
    device = params["embed"].device
    with torch.no_grad():
        _sync(device)
        t0 = time.perf_counter()
        logits, caches = prefill(params, batch)
        # reserve decode headroom in every family's cache layout up front
        caches = grow_caches(caches, S + gen)
        tok = logits.argmax(-1)[:, None]
        _sync(device)
        prefill_s = time.perf_counter() - t0
        out = [tok]
        t0 = time.perf_counter()
        for _ in range(gen - 1):
            logits, caches = decode(params, caches, {"tokens": tok})
            tok = logits.argmax(-1)[:, None]
            out.append(tok)
        _sync(device)
        decode_s = time.perf_counter() - t0
    tok_per_s = B * (gen - 1) / max(decode_s, 1e-9)
    print(f"prefill {B}x{S} in {prefill_s:.2f}s; decoded {gen} tokens in "
          f"{decode_s:.2f}s ({tok_per_s:.1f} tok/s)")
    return torch.cat(out, dim=1), {"prefill_s": prefill_s,
                                   "decode_s": decode_s,
                                   "tok_per_s": tok_per_s}


def run_engine(cfg, params, args, device, generator: torch.Generator,
               inputs=None, quiet: bool = False, mesh=None):
    """Serve ``--batch`` random prompts drawn from ``generator`` (with an
    enc-dec model, each with random encoder features [prompt_len, d] drawn
    after them; ``draw_inputs``), or ``inputs`` (prompts, embeds) when
    given; returns the finished requests and the engine (or the
    ``--replicas`` fleet)."""
    engine, tracer = _build_target(cfg, params, args, device,
                                   max_len=args.prompt_len + args.gen,
                                   mesh=mesh)
    prompts, embeds = inputs or draw_inputs(cfg, args, generator)
    if embeds is None:
        embeds = [None] * args.batch
    sp = SamplingParams(max_new_tokens=args.gen, temperature=args.temperature,
                        top_k=args.top_k, seed=args.seed)
    t0 = time.perf_counter()
    reqs = [engine.submit(p.tolist(), sp, embeds=e)
            for p, e in zip(prompts, embeds)]
    engine.run()
    wall = time.perf_counter() - t0
    if quiet:
        return reqs, engine
    n_tok = sum(len(r.tokens) for r in reqs)
    st = engine.stats()
    per = st.get("replicas", [st])
    layout = getattr(engine, "kv_layout", args.kv_layout)
    print(f"engine[{layout}]: {args.batch} requests, {n_tok} tokens "
          f"in {wall:.2f}s ({n_tok / max(wall, 1e-9):.1f} tok/s, "
          f"{st['n_steps']} steps, {args.slots} slots, "
          f"{sum(p['n_preemptions'] for p in per)} preemptions, {device})")
    for p in per:
        pool = p["pool"]
        if "arena_bytes" not in pool:             # ssm: state slots only
            print(f"state slots: {pool['n_slots']}, {pool['n_free']} free")
            continue
        print(f"kv arena: {pool['kv_dtype']}, {pool['arena_bytes']} bytes "
              f"({pool['scale_bytes']} of scales)")
        pc = pool.get("prefix_cache")
        if pc is not None:
            print(f"prefix cache: {pc['hits']}/{pc['lookups']} lookups hit, "
                  f"{pc['hit_tokens']} hit tokens, {pc['entries']} entries, "
                  f"{pc['evicted_blocks']} evicted blocks")
    _print_fleet_stats(engine)
    _print_spec_stats(engine)
    _write_observability(tracer, args)
    return reqs, engine


def run_trace(cfg, params, args, device, mesh=None):
    """Replay the --trace file through the engine (or the --replicas
    fleet); returns replay's result dict with the target and its tracer
    (None without --trace-out).  Arrivals fall due by the target's
    ``shared_clock``: on a mesh or a fleet of replica meshes, rank 0's."""
    engine, tracer = _build_target(cfg, params, args, device,
                                   max_len=args.max_len, mesh=mesh)
    trace = load_trace(args.trace)
    res = replay(engine, trace, time_scale=args.time_scale,
                 clock=engine.shared_clock)
    summary = summarize([r.metrics for r in res["finished"]], res["wall_s"])
    print(format_summary("trace", summary))
    _print_fleet_stats(engine)
    _print_spec_stats(engine)
    if res["rejected"]:
        print(f"rejected by admission control: {res['rejected']}")
    _write_observability(tracer, args)
    return dict(res, summary=summary, engine=engine, tracer=tracer)


def legacy_parity(cfg, params, args, device, inputs, oneshot_tokens):
    """``--legacy``'s check: the engine serves ``inputs`` (prompts, embeds)
    greedily, and its streams must equal the one-shot loop's
    ``oneshot_tokens`` at f32 (SystemExit otherwise); below f32 the
    diverging streams are counted.  Returns (engine streams, number of
    diverging streams, the engine)."""
    reqs, engine = run_engine(cfg, params, args, device, None,
                              inputs=inputs, quiet=True)
    eng = [r.tokens for r in reqs]
    one = oneshot_tokens.tolist()
    n_bad = sum(a != b for a, b in zip(one, eng))
    if n_bad == 0:
        print("legacy parity: engine token streams identical")
    elif cfg.dtype == torch.float32:
        raise SystemExit("legacy parity FAILED: engine and one-shot token "
                         "streams differ")
    else:
        # the engine's chunked calls and the loop's full-sequence forward
        # round low-precision chains in other orders: a greedy argmax may
        # flip at a near-tie; token identity is asserted at f32
        print(f"legacy parity: {n_bad}/{args.batch} streams diverge "
              f"(greedy near-ties under "
              f"{str(cfg.dtype).removeprefix('torch.')} fusion rounding; "
              f"rerun an f32 config for the bit-exact check)")
    return eng, n_bad, engine


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--smoke-arch", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--sparse", action="store_true",
                    help="deploy 8:16 + 16:256-outlier compressed weights")
    ap.add_argument("--weight-pattern", default="8:16")
    ap.add_argument("--outlier-pattern", default="16:256",
                    help="N:256 outlier pattern, or 'none' for plain N:M")
    ap.add_argument("--slots", type=int, default=8,
                    help="KV-pool slots (concurrent requests); per replica "
                         "with --replicas")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve with N engine replicas behind the fleet "
                         "router (serving/fleet/), on one card with one "
                         "copy of the weights; each gets its own "
                         "--slots/--n-blocks pool")
    ap.add_argument("--routing", default="prefix",
                    choices=("prefix", "round_robin", "least_loaded"),
                    help="fleet routing policy: 'prefix' scores the cached "
                         "prompt fraction minus load plus session "
                         "affinity; the baselines cycle or pick the "
                         "emptiest")
    ap.add_argument("--token-budget", type=int, default=None)
    ap.add_argument("--max-prefill-per-step", type=int, default=None,
                    help="DEPRECATED: request-count interleave bound; "
                         "aliased to --token-budget N*capacity")
    ap.add_argument("--legacy", action="store_true",
                    help="one-shot lock-step loop, then the engine on the "
                         "same prompts as a parity check")
    ap.add_argument("--kv-layout", default="slot", choices=("slot", "paged"),
                    help="contiguous per-slot KV vs paged block pool")
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per KV block (paged layout)")
    ap.add_argument("--n-blocks", type=int, default=None,
                    help="paged arena size in blocks (default: the same "
                         "device memory as the slot layout would reserve)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable prefix-cache block sharing (paged)")
    ap.add_argument("--kv-dtype", default="bf16", choices=("bf16", "int8"),
                    help="KV arena storage: bf16, or int8 with per-position "
                         "f32 scales (either layout)")
    ap.add_argument("--draft", default="none",
                    choices=("none", "ngram", "sparse", "self"),
                    help="speculative-decoding proposer: 'sparse' drafts "
                         "with the 8:16+outlier compression of the dense "
                         "weights, 'ngram' by prompt lookup, 'self' with "
                         "the target's own params")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="initial draft tokens per request per step (each "
                         "request's k then adapts to its own acceptance)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=None,
                    help="serve tensor-parallel on a DATAxMODEL mesh (e.g. "
                         "1x8; DATA must be 1), one rank a process under "
                         "torchrun --nproc-per-node DATA*MODEL")
    ap.add_argument("--trace", default=None,
                    help="JSON request trace to replay through the engine")
    ap.add_argument("--max-len", type=int, default=256,
                    help="per-slot KV capacity (trace mode)")
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--time-scale", type=float, default=1.0,
                    help="compress (<1) / stretch (>1) trace arrival gaps")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome/Perfetto trace_event JSON of the "
                         "run here (load in ui.perfetto.dev); a Prometheus "
                         "counter snapshot lands next to it")
    args = ap.parse_args(argv)
    cfg = get_smoke(args.arch) if args.smoke_arch else get(args.arch)
    if args.replicas < 1:
        ap.error("--replicas must be >= 1")
    if args.trace is not None and args.legacy:
        ap.error("--trace replays through the engine; drop --legacy")
    if args.replicas > 1 and args.legacy:
        ap.error("--replicas needs the engine path; drop --legacy")
    if args.trace is not None and cfg.family not in SUPPORTED_FAMILIES:
        ap.error(f"--trace replays through the engine, which serves "
                 f"{SUPPORTED_FAMILIES} families; {args.arch!r} is "
                 f"{cfg.family!r}")
    if args.trace is not None and cfg.family == "encdec":
        ap.error("--trace carries token prompts only; the enc-dec family "
                 "needs per-request encoder features")
    return args


def check_mesh_args(cfg, args) -> None:
    """Raise for what ``--mesh`` does not serve: the one-shot loop, which
    takes no mesh in the reference either (its ``run_oneshot`` has no mesh
    argument), so ``--mesh`` serves through the engine only."""
    if parse_mesh_spec(args.mesh) is None:
        return
    if args.legacy or cfg.family not in SUPPORTED_FAMILIES:
        raise ValueError(
            "--mesh serves through the engine; the one-shot loop (--legacy, "
            f"or the {cfg.family} family it serves) takes no mesh, as the "
            "reference's run_oneshot takes none")


def main(argv=None):
    args = parse_args(argv)
    cfg = get_smoke(args.arch) if args.smoke_arch else get(args.arch)
    check_mesh_args(cfg, args)
    if args.replicas > 1:
        mesh = make_replica_meshes(args.mesh, args.replicas, args.device)
        mesh = None if mesh[0] is None else mesh
    else:
        mesh = make_serving_mesh(args.mesh, args.device)
    if mesh is not None and dist.get_rank() != 0:
        # every rank serves; world rank 0 alone prints and writes the trace
        args = argparse.Namespace(**dict(vars(args), trace_out=None))
        with contextlib.redirect_stdout(io.StringIO()):
            return _serve(cfg, args, mesh)
    return _serve(cfg, args, mesh)


def _serve(cfg, args, mesh):
    device = resolve(args.device)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    params, report = build_params(cfg, args, device, generator)
    if args.sparse:
        print(f"sparse deploy: {report['n_layers_sparsified']} matrices, "
              f"bytes {report['dense_bytes'] / 2**20:.1f}MiB -> "
              f"{report['compressed_bytes'] / 2**20:.1f}MiB "
              f"({report['ratio']:.3f}x)")
    if args.trace is not None:
        return run_trace(cfg, params, args, device, mesh=mesh)
    if not args.legacy and cfg.family in SUPPORTED_FAMILIES:
        reqs, _ = run_engine(cfg, params, args, device, generator, mesh=mesh)
        print("sample:", reqs[0].tokens[:12])
        return reqs
    if args.legacy:
        print("--legacy: the one-shot loop, then the engine on the same "
              "prompts as a parity check")
    else:
        print(f"family {cfg.family!r} is not engine-served; using the "
              f"one-shot loop")
    inputs = draw_inputs(cfg, args, generator)
    tokens, _ = run_oneshot(cfg, params, oneshot_batch(cfg, *inputs),
                            args.gen)
    if (args.legacy and cfg.family in SUPPORTED_FAMILIES
            and args.temperature == 0):
        legacy_parity(cfg, params, args, device, inputs, tokens)
    print("sample:", tokens[0, :12].tolist())
    return tokens


if __name__ == "__main__":
    main()
