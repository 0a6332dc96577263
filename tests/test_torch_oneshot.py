"""The port's one-shot serve loop and ``--legacy`` (``launch/serve.py``'s
``run_oneshot``, ``legacy_parity``) against the JAX package's, at f32 on
smoke twins.

``run_oneshot`` (``steps.make_prefill_step``, ``model_zoo.grow_caches``,
``steps.make_decode_step``, greedy) gives token streams identical to a
JAX ``prefill`` / ``grow_caches`` / ``decode`` loop built as the
reference's ``run_oneshot`` builds it, from the same params (JAX's init
carried across) and the same numpy prompts and ``embeds``, for the dense,
vlm (``embeds`` and M-RoPE positions, no tokens), ssm, hybrid, moe and
encdec twins.  ``--legacy`` at f32 finds the engine's streams identical to
the loop's for every engine-served family, and its gate fails when they
differ.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import functools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models import grow_caches as jax_grow_caches  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.interchange import from_jax_params  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

ARCHS = ["llama-paper", "qwen2-vl-72b", "xlstm-350m", "zamba2-2.7b",
         "mixtral-8x7b", "whisper-medium"]
ENGINE_ARCHS = [a for a in ARCHS if a != "qwen2-vl-72b"]
B, S, GEN = 2, 12, 5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch intra-op thread: several test workers on one machine must
    not oversubscribe its cores (it changes no case and no tolerance);
    restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _model(arch):
    jcfg = dataclasses.replace(jax_configs.get_smoke(arch), dtype=jnp.float32)
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype=torch.float32)
    jparams = jax.jit(jax_get_model(jcfg).init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    prompts = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    embeds = (rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
              if cfg.family in ("vlm", "encdec") else None)
    return jcfg, cfg, jparams, prompts, embeds


def _jax_oneshot(jcfg, jparams, prompts, embeds):
    """The reference's ``run_oneshot`` loop on given inputs (its prefill
    and decode jitted, the same functions)."""
    zoo = jax_get_model(jcfg)
    batch = {"tokens": jnp.asarray(prompts)}
    if embeds is not None:
        batch["embeds"] = jnp.asarray(embeds)
    if jcfg.family == "vlm":
        batch["positions"] = jnp.broadcast_to(jnp.arange(S)[None, None],
                                              (3, B, S))
        del batch["tokens"]
    decode = jax.jit(zoo.decode)
    logits, caches = jax.jit(zoo.prefill)(jparams, batch)
    caches = jax_grow_caches(caches, S + GEN)
    tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    out = [tok]
    for _ in range(GEN - 1):
        logits, caches = decode(jparams, caches, {"tokens": tok})
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


@pytest.mark.parametrize("arch", ARCHS)
def test_oneshot_streams_match_jax(arch, capsys):
    jcfg, cfg, jparams, prompts, embeds = _model(arch)
    want = _jax_oneshot(jcfg, jparams, prompts, embeds)
    params = from_jax_params(jparams, device="cpu")
    batch = serve.oneshot_batch(
        cfg, torch.from_numpy(prompts).long(),
        None if embeds is None else torch.from_numpy(embeds))
    if cfg.family == "vlm":
        assert set(batch) == {"embeds", "positions"}
        assert batch["positions"].shape == (3, B, S)
        assert all(torch.equal(batch["positions"][i, b], torch.arange(S))
                   for i in range(3) for b in range(B))
    tokens, numbers = serve.run_oneshot(cfg, params, batch, GEN)
    assert tokens.shape == (B, GEN)
    np.testing.assert_array_equal(tokens.numpy(), want)
    assert numbers["prefill_s"] > 0 and numbers["decode_s"] > 0
    assert f"prefill {B}x{S} in" in capsys.readouterr().out


def _f32(monkeypatch):
    real = serve.get_smoke
    monkeypatch.setattr(serve, "get_smoke", lambda a: dataclasses.replace(
        real(a), dtype=torch.float32))


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_legacy_parity_holds_at_f32(arch, monkeypatch, capsys):
    _f32(monkeypatch)
    tokens = serve.main(["--arch", arch, "--smoke-arch", "--device", "cpu",
                         "--sparse", "--legacy", "--batch", "3",
                         "--prompt-len", "8", "--gen", "4"])
    out = capsys.readouterr().out
    assert tokens.shape == (3, 4)
    assert "legacy parity: engine token streams identical" in out
    assert "prefill 3x8 in" in out and "sample:" in out


def _diverging_engine(monkeypatch):
    """``run_engine`` whose first stream's last token is moved by one."""
    real = serve.run_engine

    def run_engine(*args, **kw):
        reqs, engine = real(*args, **kw)
        reqs[0].tokens[-1] = (reqs[0].tokens[-1] + 1) % engine.cfg.vocab
        return reqs, engine
    monkeypatch.setattr(serve, "run_engine", run_engine)


def test_legacy_parity_fails_at_f32_when_streams_differ(monkeypatch):
    _f32(monkeypatch)
    _diverging_engine(monkeypatch)
    with pytest.raises(SystemExit, match="legacy parity FAILED"):
        serve.main(["--arch", "llama-paper", "--smoke-arch", "--device",
                    "cpu", "--legacy", "--batch", "2", "--prompt-len", "8",
                    "--gen", "3"])


def test_legacy_counts_diverging_streams_below_f32(monkeypatch, capsys):
    _diverging_engine(monkeypatch)
    serve.main(["--arch", "llama-paper", "--smoke-arch", "--device", "cpu",
                "--legacy", "--batch", "2", "--prompt-len", "8", "--gen",
                "3"])
    assert ("legacy parity: 1/2 streams diverge (greedy near-ties under "
            "bfloat16 fusion rounding; rerun an f32 config for the "
            "bit-exact check)") in capsys.readouterr().out


def test_vlm_serves_through_the_oneshot_loop(capsys):
    tokens = serve.main(["--arch", "qwen2-vl-72b", "--smoke-arch",
                         "--device", "cpu", "--sparse", "--batch", "2",
                         "--prompt-len", "8", "--gen", "3"])
    out = capsys.readouterr().out
    assert tokens.shape == (2, 3)
    assert "family 'vlm' is not engine-served; using the one-shot loop" in out
    assert "sparse deploy:" in out and "legacy parity" not in out


def test_max_prefill_per_step_reaches_the_engine():
    args = serve.parse_args(["--arch", "llama-paper", "--smoke-arch",
                             "--device", "cpu", "--max-prefill-per-step",
                             "1", "--prompt-len", "8", "--gen", "4"])
    assert args.max_prefill_per_step == 1
    cfg = configs.get_smoke("llama-paper")
    params, _ = serve.build_params(cfg, args, "cpu",
                                   torch.Generator().manual_seed(0))
    engine, _ = serve._build_target(cfg, params, args, "cpu", max_len=12)
    want = ServingEngine(cfg, params, device="cpu", max_len=12,
                         max_prefill_per_step=1).token_budget
    default = ServingEngine(cfg, params, device="cpu",
                            max_len=12).token_budget
    assert engine.token_budget == want != default


@pytest.mark.parametrize("extra", [
    ["--legacy", "--trace", "t.json"],
    ["--legacy", "--replicas", "2"],
    ["--arch", "qwen2-vl-72b", "--trace", "t.json"]])
def test_cli_refuses_what_the_reference_refuses(extra):
    with pytest.raises(SystemExit):
        serve.parse_args(["--arch", "llama-paper", "--smoke-arch"] + extra)
