"""The port's attention-side model families (repro_torch.models on the
six configs gemma2-9b, gemma3-12b, internlm2-20b, qwen1.5-4b,
musicgen-medium and llama-3.2-vision-11b) against the JAX package on the
CPU. Each runs its smoke() reduction in float32 with the reference's
parameters carried across (models/carry.py::params_from_reference); the
leaves the reference initializes to zero (norm scales, qkv biases, the
cross gates) are set to seeded random values first, in both packages, so
that every option changes the result.

Tolerances (float32 on both sides; the packages sum in different orders):
  * the loss, prefill and decode logits, caches and attention outputs:
    atol = rtol = 1e-4 (tests/test_torch_lm.py's);
  * every gradient leaf: atol 1e-6, rtol 1e-4 (tests/test_torch_train.py's
    for the dense stack);
  * decode against the port's own prefill: 2e-3 (tests/test_models.py);
  * the serve engine's greedy tokens: equal.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import get_config as jget_config
from repro.models.model import decode_step as jdecode_step
from repro.models.model import forward_train as jforward_train
from repro.models.model import init_params as jinit_params
from repro.models.model import prefill as jprefill
from repro.serving import AdaptiveRequestBatcher as JBatcher
from repro.serving import ServeEngine as JServeEngine
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.train import main as train_main
from repro_torch.models import attention, get_config, list_archs
from repro_torch.models.carry import params_from_reference
from repro_torch.models.model import (
    FLOAT32_LEAVES, Model, cast_params, check_supported, decode_step, forward_train,
    init_caches, init_params, prefill,
)
from repro_torch.serving import AdaptiveRequestBatcher, ServeEngine
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

ARCHS = ["gemma2-9b", "gemma3-12b", "internlm2-20b", "qwen1.5-4b", "musicgen-medium",
         "llama-3.2-vision-11b"]
TOKEN_ARCHS = ARCHS[:4]
ATOL = RTOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
B = 2
TRAIN_S = 40  # past both smoke windows (gemma2 32, gemma3 16)
PREFILL_S, PREFILL_CACHE = 40, 48  # a prompt longer than the window: the ring wraps
DECODE_S, DECODE_CACHE, DECODE_STEPS = 12, 40, 24  # decode from below to past the window


def close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    """One config: its smoke() in float32 in both packages, the
    reference's parameters (zero-initialized leaves set to seeded values)
    carried into the port, seeded inputs, and the reference's jitted
    entry points."""
    arch = request.param
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    jcfg = jget_config(arch, smoke=True).replace(dtype="float32")
    rng = np.random.default_rng(ARCHS.index(arch))
    jp_np = jax.tree_util.tree_map(np.asarray, jinit_params(jax.random.PRNGKey(0), jcfg))
    jp_np = jax.tree_util.tree_map(
        lambda a: a if a.any() else (0.3 * rng.standard_normal(a.shape)).astype(a.dtype), jp_np)
    s = TRAIN_S + DECODE_STEPS + 1
    inputs = {}
    if cfg.embed_input:
        inputs["inputs"] = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    else:
        inputs["embeds"] = rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)
    vision = None
    if "cross" in cfg.layer_pattern:
        vision = rng.standard_normal((B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return types.SimpleNamespace(
        arch=arch, cfg=cfg, jcfg=jcfg, jp=jax.tree_util.tree_map(jnp.asarray, jp_np),
        tp=params_from_reference(jp_np, device="cpu"), inputs=inputs, vision=vision,
        targets=rng.integers(0, cfg.vocab_size, (B, TRAIN_S)).astype(np.int32),
        jgrad=jax.jit(jax.value_and_grad(
            lambda p, b: jforward_train(p, jcfg, b, remat=True, loss_chunk=16), has_aux=True)),
        jprefill=jax.jit(lambda p, b, cache_len: jprefill(p, jcfg, b, cache_len=cache_len),
                         static_argnums=2),
        jdecode=jax.jit(lambda p, b, c, cp: jdecode_step(p, jcfg, b, c, cp)))


def batch_of(f, lo, hi):
    """Positions lo..hi-1 of the inputs (tokens or frame embeddings), with
    the vision states where the config takes them."""
    out = {k: v[:, lo:hi] for k, v in f.inputs.items()}
    if f.vision is not None:
        out["vision_states"] = f.vision
    return out


def test_tree_matches_the_reference(fam):
    """The port's own init and the carried tree have the reference's
    leaves, shapes and dtypes (bf16, the configs' dtype); the cross gates
    stay float32 through the carry and cast_params."""
    cfg, jcfg = get_config(fam.arch, smoke=True), jget_config(fam.arch, smoke=True)
    want = jax.tree_util.tree_leaves_with_path(
        jax.eval_shape(lambda: jinit_params(jax.random.PRNGKey(0), jcfg)))
    own = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    carried = params_from_reference(jax.tree_util.tree_map(np.asarray, fam.jp), device="cpu",
                                    dtype=torch.bfloat16)
    names = [jax.tree_util.keystr(path) for path, _ in want]
    for tree in (own, carried, cast_params(fam.tp, torch.bfloat16)):
        got = jax.tree_util.tree_leaves_with_path(tree)
        assert [jax.tree_util.keystr(path) for path, _ in got] == names
        for (path, leaf), (_, ref) in zip(got, want):
            assert tuple(leaf.shape) == ref.shape, path
            assert str(leaf.dtype).split(".")[-1] == str(ref.dtype), path
    gates = [n for n in names if any(g in n for g in FLOAT32_LEAVES)]
    assert bool(gates) == ("cross" in cfg.layer_pattern)
    assert cast_params(carried, torch.float32)["final_norm"].dtype == torch.float32


def test_param_count_matches_the_leaves(fam):
    """tests/test_models.py::test_param_count_analytic_matches_init's 2%."""
    cfg = get_config(fam.arch, smoke=True)
    own = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    actual = sum(t.numel() for t in tree_leaves(own))
    assert abs(actual - cfg.param_count()) / actual < 0.02


def test_loss_and_gradients_match_reference(fam):
    batch = {**batch_of(fam, 0, TRAIN_S), "targets": fam.targets.copy()}
    batch["targets"][0, -5:] = -1
    (jloss, jm), jg = fam.jgrad(fam.jp, _jax(batch))
    flat, treedef = tree_flatten(fam.tp)
    leaves = [x.detach().clone().requires_grad_(True) for x in flat]
    loss, metrics = forward_train(tree_unflatten(treedef, leaves), fam.cfg, _tensors(batch),
                                  loss_chunk=16)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=ATOL, rtol=RTOL)
    assert float(metrics["tokens"]) == float(jm["tokens"]) == B * TRAIN_S - 5
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(grads) == len(jleaves)
    for got, want in zip(grads, jleaves):
        assert got.dtype == torch.float32 and got.shape == np.asarray(want).shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=GRAD_ATOL, rtol=GRAD_RTOL)
    # Model.loss is forward_train on the module's buffers.
    mloss, _ = Model(fam.cfg, fam.tp).loss(_tensors(batch))
    np.testing.assert_allclose(float(mloss.detach()), float(loss.detach()), atol=0, rtol=1e-6)


def test_prefill_logits_and_caches_match_reference(fam):
    """A prompt past the local window: the ring keeps its last tokens in
    the reference's slots."""
    batch = batch_of(fam, 0, PREFILL_S)
    jl, jc, jlast = fam.jprefill(fam.jp, _jax(batch), PREFILL_CACHE)
    tl, tc, tlast = prefill(fam.tp, fam.cfg, _tensors(batch), cache_len=PREFILL_CACHE)
    close(tl, jl)
    np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))
    assert len(tc) == len(jc) == len(fam.cfg.layer_pattern)
    for kind, got, want in zip(fam.cfg.layer_pattern, tc, jc):
        slots = {"local": min(fam.cfg.window, PREFILL_CACHE),
                 "cross": fam.cfg.n_image_tokens}.get(kind, PREFILL_CACHE)
        for name in ("k", "v"):
            assert tuple(got[name].shape) == np.asarray(want[name]).shape
            assert got[name].shape[2] == slots
            close(got[name], want[name])


def test_decode_past_the_window_matches_reference(fam):
    """Prefill below the window, then decode steps that wrap the ring."""
    jl, jc, _ = fam.jprefill(fam.jp, _jax(batch_of(fam, 0, DECODE_S)), DECODE_CACHE)
    tl, tc, _ = prefill(fam.tp, fam.cfg, _tensors(batch_of(fam, 0, DECODE_S)),
                        cache_len=DECODE_CACHE)
    close(tl, jl)
    for j in range(DECODE_STEPS):
        t = DECODE_S + j
        step = {k: v for k, v in batch_of(fam, t, t + 1).items() if k != "vision_states"}
        pos = np.full((B,), t, np.int32)
        jl, jc = fam.jdecode(fam.jp, _jax(step), jc, jnp.asarray(pos))
        tl, tc = decode_step(fam.tp, fam.cfg, _tensors(step), tc, torch.from_numpy(pos))
        close(tl, jl)
    for got, want in zip(tc, jc):
        close(got["k"], want["k"])
        close(got["v"], want["v"])


def test_decode_matches_prefill(fam):
    """The port's counterpart of tests/test_models.py's check, past the
    window: decode after a prefill gives the logits of a prefill over the
    longer prompt (the reference's 2e-3)."""
    s = PREFILL_S
    _, caches, _ = prefill(fam.tp, fam.cfg, _tensors(batch_of(fam, 0, s)), cache_len=s + 1)
    step = {k: v for k, v in batch_of(fam, s, s + 1).items() if k != "vision_states"}
    ld, _ = decode_step(fam.tp, fam.cfg, _tensors(step), caches, torch.full((B,), s))
    lf, _, _ = prefill(fam.tp, fam.cfg, _tensors(batch_of(fam, 0, s + 1)))
    assert float((ld - lf).abs().max()) < 2e-3


def test_init_caches_shapes(fam):
    caches = init_caches(fam.tp, fam.cfg, 3, 20, n_img=fam.cfg.n_image_tokens)
    for kind, c in zip(fam.cfg.layer_pattern, caches):
        length = {"local": min(fam.cfg.window, 20), "cross": fam.cfg.n_image_tokens}.get(kind, 20)
        assert c["k"].shape == c["v"].shape == (fam.cfg.n_groups, 3, length,
                                                fam.cfg.n_kv_heads, fam.cfg.head_dim_)
        assert c["k"].dtype == torch.float32


def _fixed_batcher(cls, max_batch):
    # t_min 0 and a huge t_max make the Alg-1 law k' = min(c k, max_batch)
    # whatever the rounds' wall times, so both engines admit alike.
    return cls(k0=1.0, t_min=0.0, t_max=1e9, max_batch=max_batch)


@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_engine_greedy_tokens_match_reference(arch):
    """Prompts of 9 and 30 tokens, 6 new tokens each, cache_len 40: gemma2's
    ring (32 slots) wraps while decoding, gemma3's (16) at prefill."""
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    jcfg = jget_config(arch, smoke=True).replace(dtype="float32")
    rng = np.random.default_rng(5)
    jp = jinit_params(jax.random.PRNGKey(1), jcfg)
    tp = params_from_reference(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (9, 30, 30, 9, 30)]
    jeng = JServeEngine(jcfg, jp, max_batch=3, cache_len=40, batcher=_fixed_batcher(JBatcher, 3))
    teng = ServeEngine(cfg, tp, max_batch=3, cache_len=40,
                       batcher=_fixed_batcher(AdaptiveRequestBatcher, 3), device="cpu")
    for p in prompts:
        jeng.submit(p, max_new_tokens=6)
        teng.submit(p, max_new_tokens=6)
    jdone = {r.rid: r.output for r in jeng.run()}
    tdone = {r.rid: r.output for r in teng.run()}
    assert len(tdone) == 5 and all(len(v) == 6 for v in tdone.values())
    assert tdone == jdone


@pytest.mark.parametrize("arch", ["musicgen-medium", "llama-3.2-vision-11b"])
def test_engine_and_train_launcher_refuse_non_token_inputs(arch):
    cfg = get_config(arch, smoke=True)
    tp = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="token prompts"):
        ServeEngine(cfg, tp, device="cpu")
    with pytest.raises(SystemExit):
        train_main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "1"])


@pytest.mark.parametrize("arch,missing", [
    ("moonshot-v1-16b-a3b", "MoE"), ("phi3.5-moe-42b-a6.6b", "MoE"),
    ("mamba2-780m", "SSM layers"), ("zamba2-2.7b", "SSM layers, shared attention"),
])
def test_check_supported_refuses_only_moe_ssm_and_shared_attention(arch, missing):
    """The configs this check once refused (``missing`` names what they
    need) now resolve, equal to the reference field for field, and pass
    it; it refuses an unknown layer kind and a shared-attention layer
    without its heads."""
    needs = {"MoE": lambda c: c.n_experts > 0,
             "SSM layers": lambda c: any(k.startswith("ssm") for k in c.layer_pattern),
             "shared attention": lambda c: c.shared_attn_heads > 0}
    for smoke in (False, True):
        cfg = get_config(arch, smoke=smoke)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jget_config(arch, smoke=smoke))
        assert all(needs[m](cfg) for m in missing.split(", "))
        check_supported(cfg)
    cfg = ModelConfig(**dataclasses.asdict(jget_config(arch, smoke=True)))
    with pytest.raises(ValueError, match="unknown layer kinds"):
        check_supported(cfg.replace(layer_pattern=cfg.layer_pattern + ("mlstm",)))
    with pytest.raises(ValueError, match="shared_attn_heads"):
        check_supported(cfg.replace(layer_pattern=("ssm_shared_attn",), shared_attn_heads=0))


def test_registry_holds_the_six_configs():
    """The registry holds the reference's eleven configs, the six of this
    file among them, each equal to the reference's field for field."""
    from repro.models import list_archs as jlist_archs
    assert list_archs() == jlist_archs(assigned_only=False)
    assert set(ARCHS) < set(list_archs())
    for arch in list_archs():
        for smoke in (False, True):
            cfg = get_config(arch, smoke=smoke)
            assert dataclasses.asdict(cfg) == dataclasses.asdict(jget_config(arch, smoke=smoke))
            check_supported(cfg)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


@pytest.mark.parametrize("kw,sq,skv", [
    # cross-attention: no mask, Sq != Skv, GQA, cap and scale
    (dict(causal=False, softcap_val=20.0, scale=0.3, q_chunk=8, kv_block=8), 13, 17),
    # a local layer: window, cap and scale, chunks that skip blocks behind the window
    (dict(causal=True, window=10, softcap_val=50.0, scale=1 / 16, q_chunk=8, kv_block=8), 40, 40),
])
def test_flash_cross_and_window_paths_match_reference(kw, sq, skv):
    rng = np.random.default_rng(sq + skv)
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, skv, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, skv, 2, 16)).astype(np.float32)
    w = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    jout, jvjp = jax.vjp(lambda a, b, c: jattn.flash_attention(a, b, c, **kw), q, k, v)
    want = jvjp(jnp.asarray(w))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = attention.flash_attention(tq, tk, tv, **kw)
    (out * torch.from_numpy(w)).sum().backward()
    close(out.detach(), jout)
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        close(got, ref)


def test_serve_launcher_takes_gemma2(capsys):
    serve_main(["--arch", "gemma2-9b", "--device", "cpu", "--requests", "3",
                "--max-new-tokens", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("served 3 requests; TTFT p50")
    assert out[1].startswith("adaptive admission k -> ")


def test_train_launcher_takes_gemma2(tmp_path, capsys):
    train_main(["--arch", "gemma2-9b", "--smoke", "--device", "cpu", "--steps", "2",
                "--seq", "48", "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=gemma2-9b ") and "device=cpu batch=4x48" in out[0]
    losses = [float(x.split()[3]) for x in out if x.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000002"]
