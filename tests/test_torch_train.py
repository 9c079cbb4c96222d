"""The port's training path (repro_torch.models' flash backward and
forward_train gradients, .training, .launch.steps, .launch.train)
against the JAX package on the CPU: llcysa.smoke() in float32 with the
reference's parameters carried across (models/carry.py), so both
packages compute the same function.

Tolerances (float32 on both sides; the packages sum in different orders):
  * flash backward against the reference's jax.grad: atol = rtol = 1e-4;
    against autograd of a naive attention: rtol 1e-3, atol 1e-5 (the
    reference's test_flash_grads_match_naive);
  * forward_train's gradients, every leaf: atol 1e-6, rtol 1e-4; the loss
    atol = rtol = 1e-4 (tests/test_torch_lm.py's); remat on equals remat
    off bit for bit;
  * the optimizer and the train steps: loss, grad_norm and lr rtol 1e-5;
    params atol 1e-4, a tenth of the learning rate of 1e-3 (Adam divides
    by sqrt(v), so where a gradient is near zero float32 rounding moves
    that element's step by up to a few percent of lr); m, v and err per
    leaf max |port - reference| <= 1e-4 * max |reference|; dtypes equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llcysa as jllcysa
from repro.models import attention as jattn
from repro.models.model import forward_train as jforward_train
from repro.models.model import init_params as jinit_params
from repro.training import optimizer as jopt
from repro_torch.configs import SHAPES, ShapeConfig, llcysa
from repro_torch.launch.steps import batch_shapes, build_train_step
from repro_torch.launch.train import main as train_main
from repro_torch.models import Model, attention, init_params
from repro_torch.models.carry import params_from_reference
from repro_torch.models.model import forward_train
from repro_torch.training.optimizer import OptConfig, adamw_init, adamw_update, schedule
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

CFG = llcysa.smoke().replace(dtype="float32")
JCFG = jllcysa.smoke().replace(dtype="float32")
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
SCALAR_RTOL = 1e-5
PARAM_ATOL = 1e-4
STATE_RTOL = 1e-4


@pytest.fixture(scope="module")
def params():
    jp = jinit_params(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_reference(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


_JGRAD = {}


def jgrad(remat):
    """jit(value_and_grad(forward_train)) of the reference, one per remat
    setting, shared by the tests (each compiles once per batch shape)."""
    if remat not in _JGRAD:
        _JGRAD[remat] = jax.jit(jax.value_and_grad(
            lambda p, b: jforward_train(p, JCFG, b, remat=remat, loss_chunk=16), has_aux=True))
    return _JGRAD[remat]


def token_batch(seed, b, s=40):
    toks = np.random.default_rng(seed).integers(0, CFG.vocab_size, (b, s + 1)).astype(np.int32)
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


def port_grads(tp, batch, remat):
    flat, treedef = tree_flatten(tp)
    leaves = [x.detach().clone().requires_grad_(True) for x in flat]
    loss, metrics = forward_train(tree_unflatten(treedef, leaves), CFG,
                                  {k: torch.from_numpy(v) for k, v in batch.items()},
                                  remat=remat, loss_chunk=16)
    return loss.detach(), metrics, torch.autograd.grad(loss, leaves)


def assert_state_close(got, want):
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        b = np.asarray(b)
        assert a.dtype == torch.float32 and b.dtype == np.float32
        assert float(np.abs(a.numpy() - b).max()) <= STATE_RTOL * float(np.abs(b).max())


def assert_params_close(got, want):
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert str(a.dtype).split(".")[-1] == str(np.asarray(b).dtype)
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32), rtol=0,
                                   atol=PARAM_ATOL)


def scalar_close(got, want):
    np.testing.assert_allclose(float(got), float(want), rtol=SCALAR_RTOL)


# ---------------------------------------------------------------------
# tests/test_training.py, ported
# ---------------------------------------------------------------------
def _quadratic_run(opt_cfg, steps=300):
    target = torch.from_numpy(np.random.default_rng(0).normal(size=(16,)).astype(np.float32))
    params = {"w": torch.zeros(16)}
    state = adamw_init(params, opt_cfg)
    for _ in range(steps):
        params, state, _ = adamw_update(params, {"w": 2 * (params["w"] - target)}, state,
                                        opt_cfg)
    return float(torch.sum((params["w"] - target) ** 2))


def test_adamw_converges():
    assert _quadratic_run(OptConfig(lr=5e-2, weight_decay=0.0, warmup_steps=10,
                                    total_steps=300)) < 1e-3


def test_compressed_grads_convergence_parity():
    kw = dict(lr=5e-2, weight_decay=0.0, warmup_steps=10, total_steps=300)
    l0, l1 = _quadratic_run(OptConfig(**kw)), _quadratic_run(OptConfig(**kw, compress_grads=True))
    assert l1 < max(10 * l0, 1e-2)


def test_grad_clipping_bounds_update():
    cfg = OptConfig(lr=1.0, clip_norm=1e-3, weight_decay=0.0, warmup_steps=0)
    params = {"w": torch.zeros(4)}
    _, _, metrics = adamw_update(params, {"w": torch.full((4,), 1e6)}, adamw_init(params, cfg),
                                 cfg)
    assert float(metrics["grad_norm"]) > 1e5  # measured before the clip


def test_tiny_lm_loss_decreases():
    cfg = llcysa.smoke().replace(vocab_size=256)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt_cfg = OptConfig(lr=3e-3, warmup_steps=5, total_steps=60, weight_decay=0.0)
    step = build_train_step(cfg, ShapeConfig("tiny", 64, 2, "train"), opt_cfg, remat=False,
                             device="cpu")
    state = adamw_init(params, opt_cfg)
    base = np.random.default_rng(0).integers(0, 256, 32)
    losses = []
    for i in range(40):
        seq = np.tile(base, 3)[:64]
        toks = torch.from_numpy(np.stack([seq, np.roll(seq, i % 3)]))
        params, state, m = step(params, state, {"inputs": toks,
                                                    "targets": torch.roll(toks, -1, 1)})
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.8, losses[::8]


# ---------------------------------------------------------------------
# The optimizer against the reference
# ---------------------------------------------------------------------
def test_schedule_matches_reference():
    for cfg in (dict(lr=1e-3, warmup_steps=5, total_steps=20), dict(warmup_steps=0),
                dict(lr=0.3, warmup_steps=7, total_steps=7)):
        for step in range(0, 30):
            got = schedule(OptConfig(**cfg), torch.tensor(step, dtype=torch.int32))
            want = jopt.schedule(jopt.OptConfig(**cfg), jnp.asarray(step, jnp.int32))
            assert got.dtype == torch.float32
            scalar_close(got, want)


@pytest.mark.parametrize("compress", [False, True])
def test_adamw_update_matches_reference_over_steps(compress):
    rng = np.random.default_rng(3)
    # Dicts only: the reference's compression cannot take a tuple node (see
    # test_compression_takes_the_lm_tree below).
    shapes = {"a": (5, 7), "b": {"c": (3,), "d": (2, 4)}, "e": {"f": (6,)}}

    def draw(scale):
        return jax.tree_util.tree_map(
            lambda s: (rng.standard_normal(s) * scale).astype(np.float32), shapes,
            is_leaf=lambda x: isinstance(x, tuple) and all(isinstance(i, int) for i in x))

    kw = dict(lr=1e-2, warmup_steps=3, total_steps=10, clip_norm=2.0, compress_grads=compress)
    jcfg, tcfg = jopt.OptConfig(**kw), OptConfig(**kw)
    p0 = draw(1.0)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, p0), jax.tree_util.tree_map(torch.from_numpy, p0)
    js, ts = jopt.adamw_init(jp, jcfg), adamw_init(tp, tcfg)
    assert sorted(ts) == sorted(js) and ts["step"].dtype == torch.int32
    for _ in range(12):
        g = draw(3.0)
        jp, js, jm = jopt.adamw_update(jp, jax.tree_util.tree_map(jnp.asarray, g), js, jcfg)
        tp, ts, tm = adamw_update(tp, jax.tree_util.tree_map(torch.from_numpy, g), ts, tcfg)
        assert ts["step"].dtype == torch.int32 and int(ts["step"]) == int(js["step"])
        scalar_close(tm["grad_norm"], jm["grad_norm"])
        scalar_close(tm["lr"], jm["lr"])
        assert_params_close(tp, jp)
        for key in ("m", "v") + (("err",) if compress else ()):
            assert_state_close(ts[key], js[key])
    if compress:
        assert any(float(x.abs().max()) > 0 for x in tree_leaves(ts["err"]))


def test_compression_takes_the_lm_tree(params):
    """The reference's compress_grads splits its (g, err) pairs with
    is_leaf=tuple, which also matches the parameter tree's 'groups' tuple,
    so it raises on the LM's tree (ROADMAP §3); the port walks the tree
    itself and updates every leaf."""
    jp, tp = params
    jcfg, tcfg = jopt.OptConfig(compress_grads=True), OptConfig(compress_grads=True)
    with pytest.raises(IndexError):
        jopt.adamw_update(jp, jp, jopt.adamw_init(jp, jcfg), jcfg)
    grads = jax.tree_util.tree_map(lambda x: x * 1e-3 + 1e-9, tp)
    new, state, _ = adamw_update(tp, grads, adamw_init(tp, tcfg), tcfg)
    assert isinstance(new["groups"], tuple) and isinstance(state["err"]["groups"], tuple)
    assert all(float(e.abs().max()) > 0 for e in tree_leaves(state["err"]))


def test_adamw_keeps_bf16_params_and_float32_state():
    params = {"w": torch.randn(8, generator=torch.Generator().manual_seed(0)).bfloat16()}
    cfg = OptConfig(lr=1e-2, warmup_steps=0)
    state = adamw_init(params, cfg)
    new, state, _ = adamw_update(params, {"w": torch.ones(8, dtype=torch.bfloat16)}, state, cfg)
    assert new["w"].dtype == torch.bfloat16 and state["m"]["w"].dtype == torch.float32
    assert not torch.equal(new["w"], params["w"])


# ---------------------------------------------------------------------
# The flash backward
# ---------------------------------------------------------------------
@pytest.mark.parametrize("causal,window,cap,offset", [
    (True, None, None, 0), (True, 5, None, 0), (True, None, 30.0, 0), (False, None, None, 0),
    (True, 4, 20.0, 3),
])
def test_flash_attention_backward_matches_reference(causal, window, cap, offset):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 13, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 13 + offset, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 13 + offset, 2, 8)).astype(np.float32)
    w = rng.standard_normal((2, 13, 4, 8)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap_val=cap, q_chunk=4, kv_block=4,
              q_offset=offset)
    want = jax.grad(lambda a, b, c: (jattn.flash_attention(a, b, c, **kw) * w).sum(),
                    argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    (attention.flash_attention(tq, tk, tv, **kw) * torch.from_numpy(w)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_flash_grads_match_naive():
    """tests/test_attention.py::test_flash_grads_match_naive's shapes and
    tolerance, against autograd of the port's naive attention."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 48, 4, 16), generator=g)
    k = torch.randn((2, 48, 2, 16), generator=g)
    v = torch.randn((2, 48, 2, 16), generator=g)
    w = torch.randn((2, 48, 4, 16), generator=g)

    def grads(fn, **kw):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        (fn(*xs, causal=True, window=8, softcap_val=30.0, **kw) * w).sum().backward()
        return [x.grad for x in xs]

    for a, b in zip(grads(attention.flash_attention, q_chunk=16, kv_block=16),
                    grads(attention.naive_attention)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3, atol=1e-5)


def test_flash_saves_only_its_residuals():
    """The autograd graph keeps (q, k, v, out, lse) for the attention, not
    a chunk's probabilities."""
    q, k, v = (torch.randn((1, 64, 2, 8), requires_grad=True) for _ in range(3))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.shape) or t,
                                                  lambda t: t):
        attention.flash_attention(q, k, v, q_chunk=16, kv_block=16)
    assert sorted(saved) == sorted([q.shape, k.shape, v.shape, q.shape, (1, 2, 1, 64)])


# ---------------------------------------------------------------------
# forward_train's gradients and the train step
# ---------------------------------------------------------------------
@pytest.mark.parametrize("remat", [True, False])
def test_forward_train_gradients_match_reference(params, remat):
    jp, tp = params
    batch = token_batch(21, 2)
    batch["targets"][0, -5:] = -1
    (jloss, jm), jg = jgrad(remat)(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics, grads = port_grads(tp, batch, remat)
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-4, rtol=1e-4)
    assert float(metrics["tokens"]) == float(jm["tokens"]) == batch["targets"].size - 5
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(grads) == len(jleaves) == 11
    for got, want in zip(grads, jleaves):
        assert got.dtype == torch.float32 and got.shape == np.asarray(want).shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=GRAD_ATOL, rtol=GRAD_RTOL)
    _, _, other = port_grads(tp, batch, not remat)
    assert all(torch.equal(a, b) for a, b in zip(grads, other))
    # Model.loss is forward_train on the module's buffers.
    module = Model(CFG, tp)
    mloss, _ = module.loss({k: torch.from_numpy(v) for k, v in batch.items()}, remat=remat)
    assert torch.equal(mloss.detach(), loss)


def test_bf16_gradients_stay_bf16():
    cfg = llcysa.smoke()
    tp = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    flat, treedef = tree_flatten(tp)
    leaves = [x.detach().requires_grad_(True) for x in flat]
    batch = {k: torch.from_numpy(v) for k, v in token_batch(4, 2).items()}
    loss, _ = forward_train(tree_unflatten(treedef, leaves), cfg, batch)
    grads = torch.autograd.grad(loss, leaves)
    assert all(g.dtype == torch.bfloat16 for g in grads)


@pytest.mark.parametrize("accum,global_batch", [(1, 2), (2, 4)])
def test_train_steps_match_reference(params, accum, global_batch):
    """Three build_train_step steps against a reference step composed here
    from jax.value_and_grad(forward_train) and adamw_update, with the
    reference builder's accumulation (launch/steps.py cannot be imported
    under the installed jax)."""
    jp, tp = params
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jcfg, tcfg = jopt.OptConfig(**kw), OptConfig(**kw)
    js, ts = jopt.adamw_init(jp, jcfg), adamw_init(tp, tcfg)
    step = build_train_step(CFG, ShapeConfig("t", 40, global_batch, "train"), tcfg,
                             loss_chunk=16, accum_steps=accum, device="cpu")
    mb = global_batch // accum
    for i in range(3):
        batch = token_batch(100 + i, global_batch)
        g_acc, l_sum = None, 0.0
        for j in range(accum):
            micro = {k: jnp.asarray(v[j * mb: (j + 1) * mb]) for k, v in batch.items()}
            (loss, jm), g = jgrad(True)(jp, micro)
            if accum > 1:
                g = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), g)
            g_acc = g if g_acc is None else jax.tree_util.tree_map(jnp.add, g_acc, g)
            l_sum = l_sum + loss
        if accum > 1:
            g_acc = jax.tree_util.tree_map(lambda x: x / accum, g_acc)
            jm = {"loss": l_sum / accum, "aux_loss": 0.0, "tokens": 0.0}
        jp, js, jom = jopt.adamw_update(jp, g_acc, js, jcfg)
        tp, ts, tm = step(tp, ts, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert sorted(tm) == ["aux_loss", "grad_norm", "loss", "lr", "tokens", "total_loss"]
        for key in ("loss", "aux_loss", "tokens"):
            scalar_close(tm[key], jm[key])
        scalar_close(tm["total_loss"], l_sum / accum)
        scalar_close(tm["grad_norm"], jom["grad_norm"])
        scalar_close(tm["lr"], jom["lr"])
        assert ts["step"].dtype == torch.int32 and int(ts["step"]) == i + 1
        assert_params_close(tp, jp)
        assert_state_close(ts["m"], js["m"])
        assert_state_close(ts["v"], js["v"])


def test_train_step_smoke():
    """tests/test_models.py::test_train_step_smoke's assertions for the
    ported architecture (bf16, seeded init)."""
    cfg = llcysa.smoke()
    tp = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    flat, treedef = tree_flatten(tp)
    leaves = [x.detach().requires_grad_(True) for x in flat]
    g = torch.Generator().manual_seed(0)
    batch = {"inputs": torch.randint(0, cfg.vocab_size, (2, 64), generator=g),
             "targets": torch.randint(0, cfg.vocab_size, (2, 64), generator=g)}
    loss, _ = forward_train(tree_unflatten(treedef, leaves), cfg, batch)
    grads = torch.autograd.grad(loss, leaves)
    loss = float(loss.detach())
    assert np.isfinite(loss)
    assert 1.0 < loss < 2.0 * np.log(cfg.vocab_size)
    gmax = [float(x.abs().max()) for x in grads]
    assert all(np.isfinite(x) for x in gmax) and any(x > 0 for x in gmax)


# ---------------------------------------------------------------------
# launch/: batch shapes, the launcher, the device
# ---------------------------------------------------------------------
def test_batch_shapes():
    b = batch_shapes(llcysa.CONFIG, SHAPES["train_4k"])
    assert sorted(b) == ["inputs", "targets"]
    assert b["inputs"].shape == b["targets"].shape == (256, 4096)
    assert b["inputs"].dtype == b["targets"].dtype == torch.int32
    b = batch_shapes(llcysa.CONFIG, SHAPES["decode_32k"])
    assert b["inputs"].shape == (128, 1) and "targets" not in b
    b = batch_shapes(llcysa.CONFIG.replace(embed_input=False), SHAPES["prefill_32k"])
    assert "inputs" not in b and b["embeds"].shape == (32, 32768, 768)
    assert b["embeds"].dtype == torch.bfloat16
    b = batch_shapes(llcysa.CONFIG.replace(family="vlm", n_image_tokens=9), SHAPES["train_4k"])
    assert b["vision_states"].shape == (256, 9, 768)


def test_train_launcher_runs_and_resumes(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    train_main(["--smoke", "--device", "cpu", "--steps", "3", "--ckpt-every", "2",
                "--ckpt-dir", ckpt])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=llcysa-analytics-100m ") and "device=cpu batch=4x256" in out[0]
    losses = [float(x.split()[3]) for x in out if x.startswith("step ")]
    assert [x.split()[1] for x in out if x.startswith("step ")] == ["0", "2"]
    assert all(np.isfinite(losses))
    assert out[-1] == f"checkpoints: {ckpt}"
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["step_00000002"]
    train_main(["--smoke", "--device", "cpu", "--steps", "4", "--ckpt-every", "2",
                "--ckpt-dir", ckpt, "--resume"])
    out = capsys.readouterr().out.splitlines()
    assert "resumed at step 2" in out
    assert [x.split()[1] for x in out if x.startswith("step ")] == ["3"]
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["step_00000002",
                                                                     "step_00000004"]


def test_train_step_and_launcher_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_train_step(CFG, SHAPES["train_4k"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main(["--smoke", "--steps", "1"])
