"""The port's MoE and SSM families (repro_torch.models on moonshot-v1-16b-a3b,
phi3.5-moe-42b-a6.6b, mamba2-780m and zamba2-2.7b, with models/moe.py and
models/ssm.py) against the JAX package on the CPU. Each config runs its
smoke() reduction in float32 with the reference's parameters carried
across (models/carry.py::params_from_reference); the leaves the reference
initializes to zero (norm scales, mlp_norm, the SSM's conv biases,
dt_bias, A_log and its norm) are set to seeded random values first, in
both packages, so that every option changes the result.

Tolerances (float32 on both sides; the packages sum in different orders),
tests/test_torch_families.py's:
  * the loss, aux loss, MoE and SSM outputs, prefill and decode logits and
    caches: atol = rtol = 1e-4;
  * every gradient leaf: atol 1e-6, rtol 1e-4, element-wise, but on the
    near-zero elements of zamba2's embedding gradient (those under 5% of
    the leaf's largest |reference|): |port - reference| <= 1e-5 * max
    |reference|. It is the gradient at the input of six SSM layers and the
    shared block, where XLA's and PyTorch's float32 sums part by 2e-6 to
    4.5e-6 of the leaf's largest element (measured over eight seeds),
    which is 1.3 to 5.5 times the element-wise bound on a near-zero
    element; the elements at or above 5% keep the element-wise bound (at
    this file's seed they use at most 0.36 of it). The two packages' SSD
    sits equally close to a float64 recurrence (see
    test_ssd_chunked_matches_reference_and_the_recurrence);
  * decode against the port's own prefill: 2e-3 (tests/test_models.py);
  * the serve engine's greedy tokens: equal.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import get_config as jget_config
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models.model import decode_step as jdecode_step
from repro.models.model import forward_train as jforward_train
from repro.models.model import init_params as jinit_params
from repro.models.model import prefill as jprefill
from repro.serving import AdaptiveRequestBatcher as JBatcher
from repro.serving import ServeEngine as JServeEngine
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.train import main as train_main
from repro_torch.models import get_config, moe, ssm
from repro_torch.models.carry import params_from_reference
from repro_torch.models.model import (
    FLOAT32_LEAVES, Model, cast_params, decode_step, forward_train, init_caches, init_params,
    prefill,
)
from repro_torch.serving import AdaptiveRequestBatcher, ServeEngine
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

ARCHS = ["moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b", "mamba2-780m", "zamba2-2.7b"]
ATOL = RTOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
# zamba2's embedding gradient: elements under DEEP_EMBED_NEAR_ZERO of the
# leaf's largest |reference| are held to DEEP_EMBED_GRAD_REL of it.
DEEP_EMBED_NEAR_ZERO, DEEP_EMBED_GRAD_REL = 0.05, 1e-5
DECODE_ATOL = 2e-3
B = 2
TRAIN_S = 40  # past the SSM smoke chunk of 32, not a multiple of it: padding, 2 chunks
PREFILL_S, CACHE_LEN, DECODE_STEPS = 40, 64, 16


def close(got: torch.Tensor, want, atol=ATOL, rtol=RTOL) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=rtol)


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def seeded_zeros(tree, rng):
    """The reference's tree with every zero-initialized leaf (norm scales,
    conv biases, dt_bias, A_log) set to seeded values."""
    return jax.tree_util.tree_map(
        lambda a: a if a.any() else (0.3 * rng.standard_normal(a.shape)).astype(a.dtype), tree)


@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    """One config: its smoke() in float32 in both packages, the
    reference's parameters (zero leaves set to seeded values) carried
    into the port, seeded tokens, and the reference's jitted entry
    points."""
    arch = request.param
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    jcfg = jget_config(arch, smoke=True).replace(dtype="float32")
    rng = np.random.default_rng(20 + ARCHS.index(arch))
    jp_np = seeded_zeros(
        jax.tree_util.tree_map(np.asarray, jinit_params(jax.random.PRNGKey(0), jcfg)), rng)
    return types.SimpleNamespace(
        arch=arch, cfg=cfg, jcfg=jcfg, jp_np=jp_np, jp=jax.tree_util.tree_map(jnp.asarray, jp_np),
        tp=params_from_reference(jp_np, device="cpu"),
        tokens=rng.integers(0, cfg.vocab_size, (B, PREFILL_S + DECODE_STEPS + 1)).astype(np.int32),
        targets=rng.integers(0, cfg.vocab_size, (B, TRAIN_S)).astype(np.int32),
        jgrad=jax.jit(jax.value_and_grad(
            lambda p, b: jforward_train(p, jcfg, b, remat=True, loss_chunk=16), has_aux=True)),
        jprefill=jax.jit(lambda p, b, cache_len: jprefill(p, jcfg, b, cache_len=cache_len),
                         static_argnums=2),
        jdecode=jax.jit(lambda p, b, c, cp: jdecode_step(p, jcfg, b, c, cp)))


def test_tree_dtypes_and_param_count_match_the_reference(fam):
    """The port's own init and the carried tree have the reference's
    leaves, shapes and dtypes (bf16, the configs' dtype); the router,
    dt_bias, A_log and D stay float32 through the carry and cast_params;
    the leaves count within tests/test_models.py's 2% of param_count."""
    cfg, jcfg = get_config(fam.arch, smoke=True), jget_config(fam.arch, smoke=True)
    want = jax.tree_util.tree_leaves_with_path(
        jax.eval_shape(lambda: jinit_params(jax.random.PRNGKey(0), jcfg)))
    own = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    carried = params_from_reference(fam.jp_np, device="cpu", dtype=torch.bfloat16)
    names = [jax.tree_util.keystr(path) for path, _ in want]
    for tree in (own, carried, cast_params(fam.tp, torch.bfloat16)):
        got = jax.tree_util.tree_leaves_with_path(tree)
        assert [jax.tree_util.keystr(path) for path, _ in got] == names
        for (path, leaf), (_, ref) in zip(got, want):
            assert tuple(leaf.shape) == ref.shape, path
            assert str(leaf.dtype).split(".")[-1] == str(ref.dtype), path
    f32 = {n for n, (_, ref) in zip(names, want) if ref.dtype == jnp.float32}
    assert f32 and f32 == {n for n in names if n.split("'")[-2] in FLOAT32_LEAVES}
    actual = sum(t.numel() for t in tree_leaves(own))
    assert actual == sum(int(np.prod(ref.shape)) for _, ref in want)
    assert abs(actual - cfg.param_count()) / actual < 0.02


def test_slice_wise_init_draws_one_group_at_a_time(fam, monkeypatch):
    """init_params draws every stacked leaf one group's slice at a time
    (no float32 draw of a whole stacked leaf), into a leaf of its dtype
    whose values have the reference's std or constant."""
    cfg, jcfg = get_config(fam.arch, smoke=True), jget_config(fam.arch, smoke=True)
    drawn = []
    randn = torch.randn

    def spy(shape, **kw):
        drawn.append(tuple(shape))
        return randn(shape, **kw)

    monkeypatch.setattr(torch, "randn", spy)
    own = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    monkeypatch.undo()
    ref = {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf in
           jax.tree_util.tree_leaves_with_path(jinit_params(jax.random.PRNGKey(1), jcfg))}
    n = cfg.n_groups
    want_draws = []
    for path, leaf in jax.tree_util.tree_leaves_with_path(own):
        name = jax.tree_util.keystr(path)
        jleaf = ref[name]
        assert leaf.dtype == (torch.float32 if jleaf.dtype == np.float32 else torch.bfloat16)
        assert tuple(leaf.shape) == jleaf.shape, name
        values = leaf.float().numpy()
        if np.all(jleaf == jleaf.flat[0]):  # a constant: zeros, ones, 0.25
            np.testing.assert_array_equal(values, jleaf.astype(np.float32))
            continue
        stacked = name.startswith("['groups']")
        want_draws += [tuple(leaf.shape[1:])] * n if stacked else [tuple(leaf.shape)]
        std, jstd = float(values.std()), float(jleaf.astype(np.float32).std())
        assert abs(std - jstd) < 0.15 * jstd, (name, std, jstd)
        if stacked and n > 1:
            assert not np.array_equal(values[0], values[1]), name
    assert sorted(drawn) == sorted(want_draws)


@pytest.mark.parametrize("n_tokens", [8, 80, 1000, 1023, 1024, 1025, 4096])
@pytest.mark.parametrize("e,k,cf", [(64, 6, 1.25), (16, 2, 1.25), (8, 2, 16.0)])
def test_capacity_for_matches_the_reference_across_the_1024_switch(n_tokens, e, k, cf):
    assert moe.capacity_for(n_tokens, e, k, cf) == jmoe.capacity_for(n_tokens, e, k, cf)


def _dropped_tokens(idx: np.ndarray, cap: int) -> set:
    """Tokens with an expert choice past its capacity, by the stable order
    of the flat expert ids (the reference's rule), computed here."""
    flat = idx.reshape(-1)
    order = np.argsort(flat, kind="stable")
    se = flat[order]
    pos = np.arange(len(flat)) - np.searchsorted(se, se, side="left")
    return set((order[pos >= cap] // idx.shape[1]).tolist())


def test_moe_ffn_drops_the_reference_tokens():
    """moe_ffn's output and aux loss at the default capacity factor, where
    tokens drop (the router is skewed toward some experts), and at 16,
    where none drop; the rows that differ between the two are the tokens
    the reference's rule drops, in both packages."""
    rng = np.random.default_rng(3)
    b, s, d, f, e, k = 2, 40, 32, 48, 8, 2
    x = (rng.standard_normal((b, s, d)) + 0.7).astype(np.float32)
    p = {"router": (rng.standard_normal((d, e)) / np.sqrt(d)).astype(np.float32),
         "wi_gate": (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32),
         "wi_up": (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32),
         "wo": (rng.standard_normal((e, f, d)) / np.sqrt(f)).astype(np.float32)}
    jp = {n: jnp.asarray(v) for n, v in p.items()}
    tp = {n: torch.from_numpy(v) for n, v in p.items()}
    probs = jax.nn.softmax(jnp.asarray(x.reshape(-1, d)) @ jp["router"], axis=-1)
    idx = np.asarray(jax.lax.top_k(probs, k)[1])
    out = {}
    for cf in (1.25, 16.0):
        jy, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), top_k=k, capacity_factor=cf, act="silu")
        ty, taux = moe.moe_ffn(tp, torch.from_numpy(x), top_k=k, capacity_factor=cf, act="silu")
        close(ty, jy)
        close(taux, jaux)
        out[cf] = (np.asarray(jy).reshape(b * s, d), ty.numpy().reshape(b * s, d))
    cap = moe.capacity_for(b * s, e, k, 1.25)
    dropped = _dropped_tokens(idx, cap)
    assert dropped and not _dropped_tokens(idx, moe.capacity_for(b * s, e, k, 16.0))
    for side in (0, 1):
        differ = np.abs(out[1.25][side] - out[16.0][side]).max(axis=1) > 1e-4
        assert set(np.flatnonzero(differ).tolist()) == dropped


SSD = [  # (s, chunk): a multiple of the chunk, one chunk, padding, shorter than the chunk
    (64, 16), (16, 16), (37, 16), (5, 16)]


def _ssd_inputs(rng, b, s, h, p, n):
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(0.5 * rng.standard_normal(h)).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    return x, dt, a, bm, cm


@pytest.mark.parametrize("s,chunk", SSD)
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference_and_the_recurrence(s, chunk, with_state):
    rng = np.random.default_rng(s + chunk + with_state)
    b, h, p, n = 2, 3, 4, 5
    x, dt, a, bm, cm = _ssd_inputs(rng, b, s, h, p, n)
    s0 = rng.standard_normal((b, h, n, p)).astype(np.float32) if with_state else None
    jy, js = jax.jit(lambda *args: jssm.ssd_chunked(*args[:5], chunk, initial_state=args[5]))(
        *map(jnp.asarray, (x, dt, a, bm, cm)), None if s0 is None else jnp.asarray(s0))
    ty, ts = ssm.ssd_chunked(*map(torch.from_numpy, (x, dt, a, bm, cm)), chunk,
                             initial_state=None if s0 is None else torch.from_numpy(s0))
    close(ty, jy)
    close(ts, js)
    # The step-by-step recurrence, in float64.
    state = np.zeros((b, h, n, p)) if s0 is None else s0.astype(np.float64)
    ys = []
    for t in range(s):
        da = np.exp(dt[:, t] * a)
        state = state * da[..., None, None] + np.einsum("bn,bh,bhp->bhnp", bm[:, t], dt[:, t],
                                                        x[:, t])
        ys.append(np.einsum("bn,bhnp->bhp", cm[:, t], state))
    close(ty, np.stack(ys, axis=1))
    close(ts, state)


def _ssm_case(seed, s_tail=None):
    cfg = get_config("mamba2-780m", smoke=True).replace(dtype="float32", ssm_chunk=8)
    spec = ssm.spec_from_cfg(cfg)
    rng = np.random.default_rng(seed)
    jspec = jssm.spec_from_cfg(jget_config("mamba2-780m", smoke=True).replace(
        dtype="float32", ssm_chunk=8))
    params = seeded_zeros(jax.tree_util.tree_map(
        np.asarray, jssm.init_ssm_params(jax.random.PRNGKey(seed), jspec, jnp.float32)), rng)
    return spec, jspec, rng, params


@pytest.mark.parametrize("s,s2", [(20, 13), (2, 1), (1, 2), (9, 3)])
def test_ssm_forward_state_and_continuation_match_reference(s, s2):
    """ssm_forward with return_state, the conv tail included for
    s < d_conv - 1 (3), then a continuation from that state."""
    spec, jspec, rng, params = _ssm_case(s)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    x = rng.standard_normal((2, s + s2, spec.d_model)).astype(np.float32)
    jforward = jax.jit(lambda p, x, st: jssm.ssm_forward(p, x, jspec, initial_state=st,
                                                        return_state=True))
    jy, jst = jforward(jp, jnp.asarray(x[:, :s]), None)
    ty, tst = ssm.ssm_forward(tp, torch.from_numpy(x[:, :s]), spec, return_state=True)
    close(ty, jy)
    for got, want in zip(tst, jst):
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
        close(got, want)
    jy2, jst2 = jforward(jp, jnp.asarray(x[:, s:]), jst)
    ty2, tst2 = ssm.ssm_forward(tp, torch.from_numpy(x[:, s:]), spec, initial_state=tst,
                                return_state=True)
    close(ty2, jy2)
    for got, want in zip(tst2, jst2):
        close(got, want)
    # The continuation equals one pass over the whole sequence.
    whole = ssm.ssm_forward(tp, torch.from_numpy(x), spec)
    close(torch.cat([ty, ty2], dim=1), whole)


def test_ssm_decode_step_matches_reference():
    spec, jspec, rng, params = _ssm_case(7)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    x = rng.standard_normal((2, 6, spec.d_model)).astype(np.float32)
    jst = jssm.init_ssm_state(2, jspec)
    tst = ssm.init_ssm_state(2, spec)
    for name, got, want in zip(("state", "conv"), tst, jst):
        assert tuple(got.shape) == want.shape, name
    jdecode = jax.jit(lambda p, x, st: jssm.ssm_decode_step(p, x, st, jspec))
    for t in range(6):
        jy, jst = jdecode(jp, jnp.asarray(x[:, t:t + 1]), jst)
        ty, tst = ssm.ssm_decode_step(tp, torch.from_numpy(x[:, t:t + 1]), tst, spec)
        close(ty, jy)
        for got, want in zip(tst, jst):
            close(got, want)
    close(ty, ssm.ssm_forward(tp, torch.from_numpy(x), spec)[:, -1:])


@pytest.fixture(scope="module")
def jgrads(fam):
    batch = {"inputs": fam.tokens[:, :TRAIN_S], "targets": fam.targets.copy()}
    batch["targets"][0, -5:] = -1
    return batch, fam.jgrad(fam.jp, _jax(batch))


@pytest.mark.parametrize("remat", [True, False])
def test_loss_aux_and_gradients_match_reference(fam, jgrads, remat):
    """Every gradient leaf, the router and the shared block's included (its
    nine applications in the full zamba2 add up in one leaf)."""
    batch, ((jloss, jm), jg) = jgrads
    flat, treedef = tree_flatten(fam.tp)
    leaves = [x.detach().clone().requires_grad_(True) for x in flat]
    loss, metrics = forward_train(tree_unflatten(treedef, leaves), fam.cfg, _tensors(batch),
                                  remat=remat, loss_chunk=16)
    grads = torch.autograd.grad(loss, leaves)
    close(loss, jloss)
    close(metrics["loss"], jm["loss"])
    close(metrics["aux_loss"], jm["aux_loss"])
    assert (float(metrics["aux_loss"].detach()) > 0) == bool(fam.cfg.n_experts)
    assert float(metrics["tokens"]) == float(jm["tokens"]) == B * TRAIN_S - 5
    jleaves = jax.tree_util.tree_leaves_with_path(jg)
    assert len(grads) == len(jleaves)
    for got, (path, want) in zip(grads, jleaves):
        name, want = jax.tree_util.keystr(path), np.asarray(want)
        assert got.dtype == torch.float32 and got.shape == want.shape
        got = got.numpy()
        if fam.arch == "zamba2-2.7b" and name == "['embed']":
            top = float(np.abs(want).max())
            near_zero = np.abs(want) < DEEP_EMBED_NEAR_ZERO * top
            assert 0 < near_zero.sum() < near_zero.size
            err = float(np.abs(got[near_zero] - want[near_zero]).max())
            assert err <= DEEP_EMBED_GRAD_REL * top, err
            got, want = got[~near_zero], want[~near_zero]
        np.testing.assert_allclose(got, want, atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=name)
        if "router" in name or "shared_attn" in name:
            assert float(np.abs(got).max()) > 0
    mloss, _ = Model(fam.cfg, fam.tp).loss(_tensors(batch), remat=remat)
    np.testing.assert_allclose(float(mloss.detach()), float(loss.detach()), atol=0, rtol=1e-6)


def test_prefill_and_sixteen_decode_steps_match_reference(fam):
    """A prompt of 40 (two SSM chunks, the second padded) into caches of
    64, then 16 decode steps: logits at every step, every cache leaf at
    each end."""
    jl, jc, jlast = fam.jprefill(fam.jp, {"inputs": jnp.asarray(fam.tokens[:, :PREFILL_S])},
                                 CACHE_LEN)
    tl, tc, tlast = prefill(fam.tp, fam.cfg, {"inputs": torch.from_numpy(
        fam.tokens[:, :PREFILL_S])}, cache_len=CACHE_LEN)
    close(tl, jl)
    np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))

    def same_caches(got, want):
        gl, gdef = tree_flatten(got)
        jl_, jdef = jax.tree_util.tree_flatten(want)
        assert gdef.num_leaves == len(jl_) == jdef.num_leaves
        for a, w in zip(gl, jl_):
            assert tuple(a.shape) == np.asarray(w).shape
            close(a, w)

    same_caches(tc, jc)
    ssm_kinds = [k for k in fam.cfg.layer_pattern if k.startswith("ssm")]
    for kind, c in zip(fam.cfg.layer_pattern, tc):
        want = ({"conv", "state", "sa"} if kind == "ssm_shared_attn" else {"conv", "state"}
                if kind == "ssm" else {"k", "v"})
        assert set(c) == want
    assert bool(ssm_kinds) == (fam.cfg.family in ("ssm", "hybrid"))
    for j in range(DECODE_STEPS):
        t = PREFILL_S + j
        step = {"inputs": fam.tokens[:, t:t + 1]}
        pos = np.full((B,), t, np.int32)
        jl, jc = fam.jdecode(fam.jp, _jax(step), jc, jnp.asarray(pos))
        tl, tc = decode_step(fam.tp, fam.cfg, _tensors(step), tc, torch.from_numpy(pos))
        close(tl, jl)
    same_caches(tc, jc)


def test_decode_matches_prefill(fam):
    """The port's counterpart of tests/test_models.py's check: decode after
    a prefill gives the logits of a prefill over the longer prompt (2e-3),
    with MoE at capacity_factor 16, where no token drops."""
    cfg = fam.cfg.replace(capacity_factor=16.0)
    s = PREFILL_S
    x = torch.from_numpy(fam.tokens)
    _, caches, _ = prefill(fam.tp, cfg, {"inputs": x[:, :s]}, cache_len=CACHE_LEN)
    for t in range(s, s + 4):
        ld, caches = decode_step(fam.tp, cfg, {"inputs": x[:, t:t + 1]}, caches,
                                 torch.full((B,), t))
        lf, _, _ = prefill(fam.tp, cfg, {"inputs": x[:, :t + 1]})
        assert float((ld - lf).abs().max()) < DECODE_ATOL


def test_init_caches_match_the_prefill_tree(fam):
    zero = init_caches(fam.tp, fam.cfg, 3, 20)
    _, filled, _ = prefill(fam.tp, fam.cfg, {"inputs": torch.from_numpy(
        np.repeat(fam.tokens[:1, :7], 3, axis=0))}, cache_len=20)
    (zl, zdef), (fl, fdef) = tree_flatten(zero), tree_flatten(filled)
    assert zdef == fdef
    for a, b in zip(zl, fl):
        assert a.shape == b.shape and a.dtype == b.dtype and not a.any()


def _fixed_batcher(cls, max_batch):
    # t_min 0 and a huge t_max make the Alg-1 law k' = min(c k, max_batch)
    # whatever the rounds' wall times, so both engines admit alike.
    return cls(k0=1.0, t_min=0.0, t_max=1e9, max_batch=max_batch)


def test_engine_greedy_tokens_match_reference(fam):
    """Prompts of 9 and 37 tokens (37: two SSM chunks, the second padded)
    into 3 slots, 6 new tokens each, admitted while others decode: the
    pool takes each prompt's K/V, SSM state and conv tail, and the shared
    block's K/V into its slot; the tokens equal the reference's."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, fam.cfg.vocab_size, n) for n in (9, 37, 37, 9, 37)]
    jeng = JServeEngine(fam.jcfg, fam.jp, max_batch=3, cache_len=48,
                        batcher=_fixed_batcher(JBatcher, 3))
    teng = ServeEngine(fam.cfg, fam.tp, max_batch=3, cache_len=48,
                       batcher=_fixed_batcher(AdaptiveRequestBatcher, 3), device="cpu")
    for p in prompts:
        jeng.submit(p, max_new_tokens=6)
        teng.submit(p, max_new_tokens=6)
    jdone = {r.rid: r.output for r in jeng.run()}
    tdone = {r.rid: r.output for r in teng.run()}
    assert len(tdone) == 5 and all(len(v) == 6 for v in tdone.values())
    assert tdone == jdone


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "zamba2-2.7b"])
def test_serve_launcher_takes_the_config(arch, capsys):
    serve_main(["--arch", arch, "--device", "cpu", "--requests", "3", "--max-new-tokens", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("served 3 requests; TTFT p50")
    assert out[1].startswith("adaptive admission k -> ")


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "zamba2-2.7b"])
def test_train_launcher_takes_the_config(arch, tmp_path, capsys):
    train_main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2", "--seq", "48",
                "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"arch={arch} ") and "device=cpu batch=4x48" in out[0]
    losses = [float(x.split()[3]) for x in out if x.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000002"]
