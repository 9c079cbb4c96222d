"""The port's checkpointing (repro_torch.checkpointing) against the JAX
package's: tests/test_checkpoint.py's cases, ported (bitwise resume,
crash-mid-write recovery, keep-K GC, async ordering), and each package
restoring the other's checkpoints bit for bit, bfloat16 included. There
is no tolerance: every restored leaf equals the saved one, with its
dtype."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpointing import restore_checkpoint as jrestore
from repro.checkpointing import save_checkpoint as jsave
from repro.models.model import init_params as jinit_params
from repro.configs import llcysa as jllcysa
from repro_torch.checkpointing import CheckpointManager, restore_checkpoint, save_checkpoint
from repro_torch.checkpointing.checkpoint import gc_checkpoints, list_checkpoints
from repro_torch.configs import ShapeConfig, llcysa
from repro_torch.launch.steps import build_train_step
from repro_torch.models import init_params
from repro_torch.models.carry import params_from_reference
from repro_torch.training.optimizer import OptConfig, adamw_init
from repro_torch.tree import tree_flatten, tree_leaves, tree_map


def tree():
    return {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "b": {"c": torch.ones((2,), dtype=torch.bfloat16), "d": torch.tensor(3, dtype=torch.int32)},
    }


def jtree():
    return {
        "a": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
        "b": {"c": jnp.ones((2,), jnp.bfloat16), "d": jnp.asarray(3, jnp.int32)},
    }


def assert_trees_equal(got, want):
    a, b = tree_leaves(got), tree_leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_save_restore_bitwise(tmp_path):
    t = tree()
    save_checkpoint(tmp_path, 7, t)
    step, got = restore_checkpoint(tmp_path, t)
    assert step == 7
    assert_trees_equal(got, t)


def test_restore_latest_of_many(tmp_path):
    t = tree()
    for s in (1, 5, 3):
        save_checkpoint(tmp_path, s, t)
    step, _ = restore_checkpoint(tmp_path, t)
    assert step == 5
    step, _ = restore_checkpoint(tmp_path, t, step=3)
    assert step == 3
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path, t, step=4)


def test_crash_mid_write_ignored(tmp_path):
    t = tree()
    save_checkpoint(tmp_path, 1, t)
    fake = tmp_path / "step_00000002.tmp-999-123"  # a crashed writer's leftovers
    fake.mkdir()
    (fake / "arr_00000.npy").write_bytes(b"junk")
    step, _ = restore_checkpoint(tmp_path, t)
    assert step == 1  # the tmp directory is invisible to restore
    gc_checkpoints(tmp_path, keep=3)
    assert not fake.exists()  # swept


def test_keep_k_gc(tmp_path):
    t = tree()
    for s in range(6):
        save_checkpoint(tmp_path, s, t)
    gc_checkpoints(tmp_path, keep=2)
    assert [s for s, _ in list_checkpoints(tmp_path)] == [4, 5]


def test_shape_mismatch_rejected(tmp_path):
    save_checkpoint(tmp_path, 0, tree())
    bad = tree()
    bad["a"] = torch.zeros((5, 5))
    with pytest.raises(ValueError):
        restore_checkpoint(tmp_path, bad)
    bad = tree()
    bad["e"] = torch.zeros(1)
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(tmp_path, bad)


def test_async_manager_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    t = tree()
    for s in (10, 20, 30):
        mgr.save(s, tree_map(lambda x: x + s, t))
    mgr.wait()
    assert mgr.latest_step() == 30
    step, got = mgr.restore_latest(t)
    assert step == 30 and torch.equal(got["a"], t["a"] + 30)
    assert len(list_checkpoints(tmp_path)) == 2  # keep-K applied


def test_manager_copies_before_it_returns(tmp_path):
    """The caller may update its tensors in place as soon as save returns."""
    mgr = CheckpointManager(tmp_path, keep=3)
    t = tree()
    want = tree_map(torch.clone, t)
    mgr.save(1, t)
    t["a"].add_(100)
    t["b"]["c"].mul_(3)
    mgr.wait()
    assert_trees_equal(mgr.restore_latest(tree())[1], want)


def test_resume_training_bitwise(tmp_path):
    """Interrupt-and-resume gives the uninterrupted run's parameters and
    optimizer state bit for bit (a deterministic step and a faithful
    checkpoint)."""
    cfg = llcysa.smoke().replace(vocab_size=128)
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 128, (2, 32)).astype(np.int32))
    batch = {"inputs": toks, "targets": torch.roll(toks, -1, 1)}
    step = build_train_step(cfg, ShapeConfig("t", 32, 2, "train"), opt_cfg, remat=False,
                            device="cpu")
    p0 = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    s0 = adamw_init(p0, opt_cfg)
    p, s = p0, s0
    for _ in range(6):
        p, s, _ = step(p, s, batch)
    ref_p, ref_s = p, s
    p, s = p0, s0
    for _ in range(3):
        p, s, _ = step(p, s, batch)
    save_checkpoint(tmp_path / "p", 3, p)
    save_checkpoint(tmp_path / "s", 3, s)
    _, p = restore_checkpoint(tmp_path / "p", p0)
    _, s = restore_checkpoint(tmp_path / "s", s0)
    for _ in range(3):
        p, s, _ = step(p, s, batch)
    assert_trees_equal(p, ref_p)
    assert_trees_equal(s, ref_s)


def test_leaves_go_in_the_reference_flatten_order():
    jp = jinit_params(jax.random.PRNGKey(0), jllcysa.smoke())
    tp = params_from_reference(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    jleaves = jax.tree_util.tree_leaves(jp)
    tleaves, treedef = tree_flatten(tp)
    assert treedef.num_leaves == len(jleaves) == 11
    for a, b in zip(tleaves, jleaves):
        assert a.dtype == torch.bfloat16 and tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))


def test_the_reference_restores_the_ports_checkpoint(tmp_path):
    jp = jinit_params(jax.random.PRNGKey(1), jllcysa.smoke())  # bf16 leaves
    tp = params_from_reference(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    state = {"params": tp, "step": torch.tensor(9, dtype=torch.int32), "t": tree()}
    save_checkpoint(tmp_path, 9, state)
    manifest = json.loads((tmp_path / "step_00000009" / "manifest.json").read_text())
    assert manifest["n_leaves"] == 15 and manifest["leaves"][0]["dtype"] == "bfloat16"
    like = {"params": jp, "step": jnp.asarray(0, jnp.int32), "t": jtree()}
    step, got = jrestore(tmp_path, like)
    assert step == 9
    for a, b in zip(jax.tree_util.tree_leaves(got), tree_leaves(state)):
        a = np.asarray(a)
        assert str(a.dtype) == str(b.dtype).split(".")[-1]
        np.testing.assert_array_equal(a.astype(np.float32), b.float().numpy())
        if b.dtype == torch.bfloat16:  # the bits themselves
            np.testing.assert_array_equal(a.view(np.uint16), b.view(torch.int16).numpy()
                                          .view(np.uint16))


def test_the_port_restores_the_references_checkpoint(tmp_path):
    jp = jinit_params(jax.random.PRNGKey(2), jllcysa.smoke())
    like_p = params_from_reference(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    jsave(tmp_path, 4, {"params": jp, "t": jtree()})
    step, got = restore_checkpoint(tmp_path, {"params": tree_map(torch.zeros_like, like_p),
                                              "t": tree_map(torch.zeros_like, tree())})
    assert step == 4
    assert_trees_equal(got["params"], like_p)
    assert_trees_equal(got["t"], tree())
