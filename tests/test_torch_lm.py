"""The port's analytics LM serve path (repro_torch.models, .serving,
.launch.serve) against the JAX package on the CPU: llcysa.smoke() in
float32 with the reference's parameters carried across
(models/carry.py::params_from_reference), so both packages compute the
same function. Logits and losses agree within atol = rtol = 1e-4 (float32
through two layers, different matmul orders); the serve engine's greedy
tokens and the Alg-1 batcher's k trajectory are equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llcysa as jllcysa
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.model import decode_step as jdecode_step
from repro.models.model import forward_train as jforward_train
from repro.models.model import init_params as jinit_params
from repro.models.model import prefill as jprefill
from repro.serving import AdaptiveRequestBatcher as JBatcher
from repro.serving import ServeEngine as JServeEngine
from repro_torch.configs import llcysa
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import Model, attention, get_config, layers
from repro_torch.models.carry import params_from_reference
from repro_torch.models.model import (
    cast_params, decode_step, forward_train, init_caches, init_params, prefill,
)
from repro_torch.serving import AdaptiveRequestBatcher, ServeEngine

ATOL = RTOL = 1e-4
CFG = llcysa.smoke().replace(dtype="float32")
JCFG = jllcysa.smoke().replace(dtype="float32")


@pytest.fixture(scope="module")
def params():
    jp = jinit_params(jax.random.PRNGKey(0), JCFG)
    jp_np = jax.tree_util.tree_map(np.asarray, jp)
    return jp, params_from_reference(jp_np, device="cpu")


def close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, shape).astype(np.int32)


def test_carried_params_keep_the_reference_tree(params):
    jp, tp = params
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jleaves) == 11  # embed, final_norm and nine per-layer leaves
    assert tp["groups"][0]["wq"].shape == (2, 64, 64)
    for path, leaf in jleaves:
        node = tp
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        assert node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_own_init_matches_the_tree_and_is_seeded(params):
    _, tp = params
    a = init_params(CFG, torch.Generator().manual_seed(3), device="cpu")
    b = init_params(CFG, torch.Generator().manual_seed(3), device="cpu")
    for (_, la), (_, lb), (_, lt) in zip(*(jax.tree_util.tree_leaves_with_path(x)
                                            for x in (a, b, tp))):
        assert la.shape == lt.shape and la.dtype == lt.dtype
        assert torch.equal(la, lb)


@pytest.mark.parametrize("s", [1, 7, 12])
def test_prefill_then_decode_logits_match_reference(params, s):
    jp, tp = params
    toks = tokens(s, (2, s + 3))
    cache_len = s + 4
    jl, jc, jlast = jprefill(jp, JCFG, {"inputs": jnp.asarray(toks[:, :s])}, cache_len=cache_len)
    tl, tc, tlast = prefill(tp, CFG, {"inputs": torch.from_numpy(toks[:, :s]).long()},
                            cache_len=cache_len)
    close(tl, jl)
    np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))
    close(tc[0]["k"], jc[0]["k"])
    close(tc[0]["v"], jc[0]["v"])
    for j in range(3):
        pos = np.full((2,), s + j, np.int32)
        jl, jc = jdecode_step(jp, JCFG, {"inputs": jnp.asarray(toks[:, s + j: s + j + 1])}, jc,
                              jnp.asarray(pos))
        tl, tc = decode_step(tp, CFG, {"inputs": torch.from_numpy(toks[:, s + j: s + j + 1]).long()},
                             tc, torch.from_numpy(pos))
        close(tl, jl)


def test_decode_matches_prefill(params):
    """The port's counterpart of tests/test_models.py's check: a decode step
    after a prefill gives the logits of a prefill over the longer prompt
    (the reference's 2e-3)."""
    _, tp = params
    toks = torch.from_numpy(tokens(11, (2, 17))).long()
    _, caches, _ = prefill(tp, CFG, {"inputs": toks[:, :16]}, cache_len=17)
    ld, _ = decode_step(tp, CFG, {"inputs": toks[:, 16:]}, caches, torch.full((2,), 16))
    lf, _, _ = prefill(tp, CFG, {"inputs": toks})
    assert float((ld - lf).abs().max()) < 2e-3


@pytest.mark.parametrize("with_pad", [False, True])
def test_forward_loss_matches_reference(params, with_pad):
    jp, tp = params
    toks = tokens(21, (2, 41))
    inputs, targets = toks[:, :-1], toks[:, 1:].copy()
    if with_pad:
        targets[0, -5:] = -1
    jloss, jm = jforward_train(jp, JCFG, {"inputs": jnp.asarray(inputs),
                                          "targets": jnp.asarray(targets)}, loss_chunk=16)
    tloss, tm = forward_train(tp, CFG, {"inputs": torch.from_numpy(inputs).long(),
                                        "targets": torch.from_numpy(targets).long()},
                              loss_chunk=16)
    close(tloss, jloss)
    assert float(tm["tokens"]) == float(jm["tokens"]) == targets.size - 5 * with_pad
    module = Model(CFG, tp)
    mloss, _ = module({"inputs": torch.from_numpy(inputs).long(),
                       "targets": torch.from_numpy(targets).long()})
    assert torch.equal(mloss, tloss)


def _fixed_batcher(cls, max_batch):
    # t_min 0 and a huge t_max make the Alg-1 law k' = min(c k, max_batch)
    # whatever the rounds' wall times, so both engines admit alike.
    return cls(k0=1.0, t_min=0.0, t_max=1e9, max_batch=max_batch)


def test_engine_greedy_tokens_match_reference(params):
    jp, tp = params
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, CFG.vocab_size, int(rng.integers(3, 20))) for _ in range(7)]
    jeng = JServeEngine(JCFG, jp, max_batch=3, cache_len=40, batcher=_fixed_batcher(JBatcher, 3))
    teng = ServeEngine(CFG, tp, max_batch=3, cache_len=40,
                       batcher=_fixed_batcher(AdaptiveRequestBatcher, 3), device="cpu")
    for p in prompts:
        jeng.submit(p, max_new_tokens=6)
        teng.submit(p, max_new_tokens=6)
    jdone = {r.rid: r.output for r in jeng.run()}
    tdone = {r.rid: r.output for r in teng.run()}
    assert len(tdone) == 7 and all(len(v) == 6 for v in tdone.values())
    assert tdone == jdone
    assert teng.batcher.k == jeng.batcher.k
    assert [n for _, n in teng.batcher.history] == [n for _, n in jeng.batcher.history]


def test_engine_defaults_to_cuda_and_raises_without_it(params, monkeypatch):
    _, tp = params
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(CFG, tp)


def test_batcher_k_trajectory_matches_reference():
    rng = np.random.default_rng(9)
    j, t = JBatcher(max_batch=16), AdaptiveRequestBatcher(max_batch=16)
    for _ in range(40):
        runtime, served = float(rng.uniform(0.001, 1.0)), int(rng.integers(0, 12))
        waiting, free = int(rng.integers(0, 20)), int(rng.integers(0, 16))
        assert t.admit(waiting, free) == j.admit(waiting, free)
        j.update(runtime, served)
        t.update(runtime, served)
        assert t.k == j.k
    assert t.history == j.history


@pytest.mark.parametrize("causal,window,cap,offset", [
    (True, None, None, 0), (True, 5, None, 0), (True, None, 30.0, 0), (False, None, None, 0),
    (True, 4, 20.0, 3),
])
def test_flash_attention_forward_matches_reference(causal, window, cap, offset):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 13, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 13 + offset, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 13 + offset, 2, 8)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap_val=cap, q_chunk=4, kv_block=4,
              q_offset=offset)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = attention.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), **kw)
    close(got, want)


@pytest.mark.parametrize("window,ring", [(None, False), (6, True)])
def test_decode_attention_matches_reference(window, ring):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((3, 1, 4, 8)).astype(np.float32)
    kc = rng.standard_normal((3, 10, 2, 8)).astype(np.float32)
    vc = rng.standard_normal((3, 10, 2, 8)).astype(np.float32)
    cur = np.asarray([0, 4, 15 if ring else 9], np.int32)
    jslots = jattn.ring_slot_positions(jnp.asarray(cur), 10) if ring else None
    tslots = attention.ring_slot_positions(torch.from_numpy(cur), 10) if ring else None
    if ring:
        np.testing.assert_array_equal(tslots.numpy(), np.asarray(jslots))
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                  jnp.asarray(cur), window=window, softcap_val=25.0,
                                  slot_positions=jslots)
    got = attention.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                     torch.from_numpy(vc), torch.from_numpy(cur), window=window,
                                     softcap_val=25.0, slot_positions=tslots)
    close(got, want)


def test_layers_match_reference():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    pos = np.tile(np.arange(5, dtype=np.int32), (2, 1))
    tx = torch.from_numpy(x)
    close(layers.rms_norm(tx, torch.from_numpy(scale)), jlayers.rms_norm(jnp.asarray(x),
                                                                          jnp.asarray(scale)))
    close(layers.apply_rope(tx, torch.from_numpy(pos), 10000.0),
          jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))
    for kind in ("silu", "gelu"):
        close(layers.activation(tx, kind), jlayers.activation(jnp.asarray(x), kind))
    close(layers.softcap(tx * 40, 30.0), jlayers.softcap(jnp.asarray(x) * 40, 30.0))
    w = [rng.standard_normal(s).astype(np.float32) / 4 for s in ((16, 24), (16, 24), (24, 16))]
    close(layers.mlp_glu(tx, *map(torch.from_numpy, w), "silu"),
          jlayers.mlp_glu(jnp.asarray(x), *map(jnp.asarray, w), "silu"))
    table = rng.standard_normal((50, 16)).astype(np.float32)
    toks = rng.integers(0, 50, (2, 7))
    for scale_emb in (False, True):
        close(layers.embed(torch.from_numpy(toks), torch.from_numpy(table), scale_emb),
              jlayers.embed(jnp.asarray(toks), jnp.asarray(table), scale_emb))
    close(layers.unembed(tx[..., 0, :], torch.from_numpy(table), True),
          jlayers.unembed(jnp.asarray(x[..., 0, :]), jnp.asarray(table), True))


def test_registry_and_unported_configs():
    """Every registered config resolves (the MoE and SSM ones included), an
    unknown name raises, and the dense smoke config with experts gets the
    MoE sub-dict in place of its dense MLP."""
    assert get_config("llcysa-analytics-100m").d_model == 768
    assert get_config("llcysa-analytics-100m", smoke=True) == llcysa.smoke()
    assert get_config("mamba2-780m").layer_pattern == ("ssm",)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("mamba3-1b")
    tp = init_params(CFG.replace(n_experts=4, top_k=2), torch.Generator(), device="cpu")
    layer = tp["groups"][0]
    assert "wi_gate" not in layer and set(layer["moe"]) == {"router", "wi_gate", "wi_up", "wo"}
    assert layer["moe"]["router"].shape == (2, 64, 4)
    assert layer["moe"]["router"].dtype == torch.float32


def test_init_caches_and_cast(params):
    _, tp = params
    caches = init_caches(tp, CFG, 3, 20)
    assert caches[0]["k"].shape == (2, 3, 20, 4, 16) and caches[0]["k"].dtype == torch.float32
    bf = cast_params(tp, torch.bfloat16)
    assert bf["groups"][0]["wo"].dtype == torch.bfloat16


def test_bf16_serve_runs_on_the_cpu():
    cfg = llcysa.smoke()
    tp = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = ServeEngine(cfg, tp, max_batch=2, cache_len=32, device="cpu")
    for n in (5, 9, 3):
        eng.submit(tokens(n, n), max_new_tokens=4)
    done = eng.run()
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert all(len(r.output) == 4 and all(0 <= t < cfg.vocab_size for t in r.output)
               for r in done)


def test_serve_launcher_prints_the_two_summary_lines(capsys):
    serve_main(["--device", "cpu", "--requests", "3", "--max-new-tokens", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("served 3 requests; TTFT p50")
    assert out[1].startswith("adaptive admission k -> ")
