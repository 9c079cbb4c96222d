"""The port's distribution layer held to the reference's.

* Spec trees: repro_torch.distributed.sharding's param, cache, batch and
  ZeRO-1 specs and ctx.default_rules equal the reference's leaf for leaf
  (``tuple(spec)``), exactly, for every registered config on (data=16,
  model=16), (pod=2, data=16, model=16) and (data=2, model=4).
* Four gloo processes (tests/_torch_dist_worker.py, one spawn for the
  module) on CPU meshes:
  - each rank's slab of a ('pod', 'data')-sharded batch on a (2, 2, 1)
    mesh is the one the reference's NamedSharding.devices_indices_map
    gives the device at the same mesh coordinates;
  - the expert-parallel MoE on a (2, 2) mesh against the reference's
    shard_map path on four host devices (a JAX subprocess), at capacity
    factor 1.25 and at 0.25, where tokens drop per data shard: y within
    rtol 1e-5 / atol 1e-6 and aux within rtol 1e-6; and its gradients
    against autograd of the single-device path where nothing drops;
  - tests/test_distributed.py's config (gemma2-9b smoke, 4 heads, d_ff
    128, vocab 512, float32) trained two steps with ZeRO-1 (and again
    with sequence parallelism, and with two microbatches), the same with
    one kv head (it does not divide 'model'), and mamba2-780m's smoke
    with sequence parallelism, on a (2, 2) mesh: loss and grad norm
    within rtol 1e-5 of the single-device step's. After each step Adam's
    count is equal, and m and sqrt(v) (continuous in the gradient, and
    as exact as it; v, its square, doubles its relative error) are within
    rtol 1e-5 and atol 1e-5 of each leaf's largest value. Each step's
    parameter update is within 0.1 x lr of the single-device one on all
    but 0.1% of the elements: Adam's first steps move a parameter by about
    lr x sign(g), so a gradient within float32 rounding of zero may flip
    its sign on the mesh and move that parameter by up to 2 x lr, while a
    skipped or wrong update is off by about lr nearly everywhere. The
    reference test's expectations hold: embed sharded over 'model', some
    m leaf over 'data'. The launcher's batch and stop flag on the mesh:
    every rank steps on rank 0's batch (each rank offers its own) with the
    single-device loss on it, and a stop on one rank reaches all. Prefill (past the local
    layers' window) and three decode steps on the mesh against the
    single-device ones, for the three configs: logits within rtol 1e-5 /
    atol 1e-5.
* A fake process group in a subprocess: cost_analysis counts one device's
  FLOPs of a product on a (16, 16) mesh (the global count / 256), and a
  smoke cell's dry-run record has the reference's keys, parameter bytes
  equal to the spec tree's and collectives.
* launch/: plan_cells, batch_shapes and cache_shapes as the reference's
  tests/test_launch.py states them, roofline_terms and the roofline report,
  and the train launcher on a (1, 1) 'dev' mesh.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import SHAPES
from repro_torch.distributed import ctx as tctx
from repro_torch.distributed import sharding as tsh
from repro_torch.models import get_config as t_get_config
from repro_torch.models import list_archs

SRC = str(Path(__file__).resolve().parents[1] / "src")
TESTS = str(Path(__file__).resolve().parent)

ARCHS = list_archs()
MESHES = {
    "data16_model16": (("data", "model"), (16, 16)),
    "pod2_data16_model16": (("pod", "data", "model"), (2, 16, 16)),
    "data2_model4": (("data", "model"), (2, 4)),
}
MOE = dict(b=4, s=32, d=32, ff=64, e=8, top_k=2, factors=(1.25, 0.25))


class _RefMesh:
    """The reference's stand-in mesh (tests/test_distributed.py)."""

    def __init__(self, names, shape):
        self.axis_names = names
        self.shape = dict(zip(names, shape))


def _ref_plain(tree):
    import jax
    from jax.sharding import PartitionSpec

    return jax.tree_util.tree_map(tuple, tree, is_leaf=lambda x: isinstance(x, PartitionSpec))


def _port_plain(tree):
    return tsh.spec_map(tuple, tree)


def _meshes(key):
    names, shape = MESHES[key]
    return _RefMesh(names, shape), tsh.MeshShape(names, shape)


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch):
    import jax

    from repro.models import get_config, init_params

    return jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0), get_config(arch)))


def test_registered_archs_are_the_reference_s():
    from repro.models import list_archs as ref_list

    assert ARCHS == ref_list(assigned_only=False)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, mesh):
    from repro.distributed import sharding as rsh
    from repro.models import get_config

    ref_mesh, port_mesh = _meshes(mesh)
    want = _ref_plain(rsh.param_specs(get_config(arch), ref_mesh))
    assert _port_plain(tsh.param_specs(t_get_config(arch), port_mesh)) == want


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_match_reference(arch, mesh):
    from repro.distributed import sharding as rsh
    from repro.models import get_config

    ref_mesh, port_mesh = _meshes(mesh)
    for shape in SHAPES.values():
        b = shape.global_batch
        assert (_port_plain(tsh.cache_specs(t_get_config(arch), port_mesh, b))
                == _ref_plain(rsh.cache_specs(get_config(arch), ref_mesh, b)))
        assert (_port_plain(tsh.batch_specs(t_get_config(arch), port_mesh, b))
                == _ref_plain(rsh.batch_specs(get_config(arch), ref_mesh, b)))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_specs_match_reference(arch, mesh):
    from repro.distributed import sharding as rsh
    from repro.models import get_config

    ref_mesh, port_mesh = _meshes(mesh)
    shapes = _ref_shapes(arch)
    want = _ref_plain(rsh.zero1_specs(rsh.param_specs(get_config(arch), ref_mesh), shapes,
                                      ref_mesh))
    got = tsh.zero1_specs(tsh.param_specs(t_get_config(arch), port_mesh), shapes, port_mesh)
    assert _port_plain(got) == want


@pytest.mark.parametrize("seq_parallel", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_default_rules_match_reference(arch, mesh, seq_parallel):
    from repro.distributed import ctx as rctx
    from repro.models import get_config

    ref_mesh, port_mesh = _meshes(mesh)
    for shape in SHAPES.values():
        kw = dict(seq_parallel=seq_parallel, seq_len=shape.seq_len)
        want = rctx.default_rules(get_config(arch), ref_mesh, shape.global_batch, **kw)
        got = tctx.default_rules(t_get_config(arch), port_mesh, shape.global_batch, **kw)
        assert {k: tuple(v) for k, v in got.items()} == {k: tuple(v) for k, v in want.items()}


def test_sharding_specs_divisibility_fallbacks():
    """tests/test_distributed.py's fallbacks: qwen1.5 (20 heads) on a
    16-way model axis replicates its attention weights while FFN and
    vocab shard; mamba2's vocab 50,280 does not divide 16."""
    mesh = tsh.MeshShape(("data", "model"), (16, 16))
    specs = tsh.param_specs(t_get_config("qwen1.5-4b"), mesh)
    g0 = specs["groups"][0]
    assert g0["wq"] == tsh.P(None, None, None)
    assert g0["wi_gate"] == tsh.P(None, None, "model")
    assert specs["embed"] == tsh.P("model", None)
    assert tsh.param_specs(t_get_config("mamba2-780m"), mesh)["embed"] == tsh.P(None, None)


def test_to_placements_and_local_shape():
    from torch.distributed.tensor import Replicate, Shard

    mesh = tsh.MeshShape(("pod", "data", "model"), (2, 16, 16))
    spec = tsh.P(("pod", "data"), None, "model")
    assert tsh.to_placements(spec, mesh) == (Shard(0), Shard(0), Shard(2))
    assert tsh.to_placements(tsh.P(), mesh) == (Replicate(),) * 3
    assert tsh.local_shape((64, 3, 32), spec, mesh) == (2, 3, 2)
    assert tsh.P(("data",), None) == tsh.P("data", None)
    with pytest.raises(ValueError):
        tsh.local_shape((30, 3, 32), spec, mesh)


def test_constrain_outside_a_context_is_identity():
    x = torch.ones(3)
    assert tctx.constrain("activations", x) is x
    with tctx.sharding_context(tsh.MeshShape(("data", "model"), (1, 1)), {}):
        assert tctx.constrain("activations", x) is x  # not a DTensor
        assert tctx.current_mesh() is not None
    assert tctx.current_mesh() is None


# --------------------------------------------------------------------------
# Four gloo processes against the reference on four host devices.
# --------------------------------------------------------------------------
REF_SCRIPT = textwrap.dedent(
    """
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.distributed.ctx import sharding_context
    from repro.models.moe import moe_ffn

    out_dir = sys.argv[1]
    res = {}
    mesh3 = jax.make_mesh((2, 2, 1), ("pod", "data", "model"))
    idx = NamedSharding(mesh3, P(("pod", "data"), None)).devices_indices_map((8, 3))
    batch = np.arange(8 * 3, dtype=np.int32).reshape(8, 3)
    res["layout"] = [[list(map(int, c)), batch[idx[d]].tolist()]
                     for c, d in np.ndenumerate(mesh3.devices)]
    inp = dict(np.load(os.path.join(out_dir, "moe_inputs.npz")))
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    params = {k: jnp.asarray(inp[k]) for k in ("router", "wi_gate", "wi_up", "wo")}
    for cf in (float(c) for c in inp["factors"]):
        with sharding_context(mesh, {}):
            y, aux = moe_ffn(params, jnp.asarray(inp["x"]), top_k=int(inp["top_k"]),
                             capacity_factor=cf, act="silu")
        res["moe_%s" % cf] = [np.asarray(y).tolist(), float(aux)]
    print("RESULT " + json.dumps(res))
    """
)


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(25)
    m = MOE
    np.savez(
        out / "moe_inputs.npz",
        x=rng.standard_normal((m["b"], m["s"], m["d"])).astype(np.float32),
        router=(rng.standard_normal((m["d"], m["e"])) / np.sqrt(m["d"])).astype(np.float32),
        wi_gate=(rng.standard_normal((m["e"], m["d"], m["ff"])) / np.sqrt(m["d"])).astype(
            np.float32),
        wi_up=(rng.standard_normal((m["e"], m["d"], m["ff"])) / np.sqrt(m["d"])).astype(
            np.float32),
        wo=(rng.standard_normal((m["e"], m["ff"], m["d"])) / np.sqrt(m["ff"])).astype(
            np.float32),
        w=rng.standard_normal((m["b"], m["s"], m["d"])).astype(np.float32),
        top_k=np.int64(m["top_k"]), factors=np.array(m["factors"]))
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(out)], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    import torch.multiprocessing as mp

    sys.path.insert(0, TESTS)
    try:
        import _torch_dist_worker as worker
    finally:
        sys.path.remove(TESTS)
    mp.spawn(worker.main, args=(str(out / "store"), str(out)), nprocs=4)
    stdout, stderr = ref.communicate(timeout=600)
    assert ref.returncode == 0, stderr[-3000:]
    line = [l for l in stdout.splitlines() if l.startswith("RESULT ")][0]
    return (json.loads((out / "torch_result.json").read_text()),
            json.loads(line[len("RESULT "):]))


def test_batch_shard_layout_matches_named_sharding(gloo_run):
    got, want = gloo_run
    by_coord = {tuple(c): rows for c, rows in want["layout"]}
    assert len(got["layout"]) == 4
    for coord, rows in got["layout"]:
        assert rows == by_coord[tuple(coord)]


def test_mesh_builders_refuse_a_wrong_world_size(gloo_run):
    got, _ = gloo_run
    assert "256 ranks" in got["mesh_error_production"]
    assert "8 ranks" in got["mesh_error_dev"]


@pytest.mark.parametrize("factor", MOE["factors"])
def test_expert_parallel_moe_matches_reference(gloo_run, factor):
    got, want = gloo_run
    y, aux = got[f"moe_{factor}"]
    y_ref, aux_ref = want[f"moe_{factor}"]
    np.testing.assert_allclose(np.array(y), np.array(y_ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux, aux_ref, rtol=1e-6)


def test_expert_parallel_moe_drops_tokens_at_low_capacity(gloo_run):
    """At capacity factor 0.25 some tokens drop: y differs from 1.25's."""
    got, _ = gloo_run
    assert not np.allclose(np.array(got["moe_0.25"][0]), np.array(got["moe_1.25"][0]))


def test_expert_parallel_moe_gradients(gloo_run):
    got, _ = gloo_run
    assert got["moe_y_nodrop_err"] < 1e-5
    for k, err in got["moe_grad_err"].items():
        assert err <= 1e-5 * max(1.0, got["moe_grad_scale"][k]), (k, err)


TRAIN_RUNS = ["gemma-zero1", "gemma-seq_parallel", "gemma-accum", "gqa-zero1",
              "mamba-seq_parallel"]


@pytest.mark.parametrize("run", TRAIN_RUNS)
def test_sharded_train_steps_match_single_device(gloo_run, run):
    got, _ = gloo_run
    for step in got[f"train_{run}"]:
        for want, have in step:  # loss, grad norm
            np.testing.assert_allclose(have, want, rtol=1e-5)
    for i, state in enumerate(got[f"opt_state_{run}"]):
        assert state["step"] == [i + 1, i + 1]
        assert state["m"] <= 1.0 and state["sqrt_v"] <= 1.0, (i, state)
    assert max(got[f"update_off_share_{run}"]) <= 1e-3, got[f"update_off_share_{run}"]
    assert got[f"param_err_{run}"] <= 2 * sum(got["train_lr"])
    assert "Shard(dim=0)" in got[f"embed_placements_{run}"]  # embed over 'model'
    assert got[f"m_data_sharded_{run}"]
    rules = got[f"rules_{run}"]
    assert rules["activations"][1] == ("model" if run.endswith("seq_parallel") else None)


def test_launcher_steps_every_rank_on_rank0s_batch(gloo_run):
    got, _ = gloo_run
    ranks = got["launcher_ranks"]
    assert [r["batch_is_rank0s"] for r in ranks] == [True] * 4
    for r in ranks:
        np.testing.assert_allclose(r["loss"], got["launcher_plain_loss"], rtol=1e-5)
    assert [r["stop_flags"] for r in ranks] == [[True, False]] * 4


@pytest.mark.parametrize("variant,cache", [("gemma", "Shard(dim=3)"), ("gqa", "Shard(dim=2)"),
                                           ("mamba", "Shard(dim=2)")])
def test_sharded_prefill_and_decode_match_single_device(gloo_run, variant, cache):
    """Prefill, then three decode steps; gemma's kv heads shard over
    'model', gqa's one kv head does not (its cache shards the sequence and
    its decode combines the ranks' partial softmaxes), mamba's SSM state
    shards its heads."""
    got, _ = gloo_run
    want, have = got[f"prefill_{variant}"]
    np.testing.assert_allclose(np.array(have), np.array(want), rtol=1e-5, atol=1e-5)
    for want, have in got[f"decode_{variant}"]:
        np.testing.assert_allclose(np.array(have), np.array(want), rtol=1e-5, atol=1e-5)
    assert cache in got[f"cache_placements_{variant}"]


# --------------------------------------------------------------------------
# A fake process group: cost analysis and one dry-run cell.
# --------------------------------------------------------------------------
FAKE_SCRIPT = textwrap.dedent(
    """
    import json
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import P, shard_tree_empty
    from repro_torch.launch import cost_analysis
    from repro_torch.launch.dryrun import fake_world, run_cell_on
    from repro_torch.launch.mesh import make_dev_mesh, make_production_mesh
    from repro_torch.launch.steps import TensorSpec
    from repro_torch.models import get_config

    res = {}
    with fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        with FakeTensorMode():
            a = shard_tree_empty(TensorSpec((256, 4096, 3584), torch.bfloat16),
                                 P("data", None, None), mesh)
            b = shard_tree_empty(TensorSpec((3584, 14336), torch.bfloat16),
                                 P(None, "model"), mesh)
            rec = cost_analysis.measure(lambda x, y: x @ y, a, b)
            res["probe_local"] = list(rec["out"].to_local().shape)
        res["probe_flops"] = rec["cost"]["flops_per_device"]
        res["probe_collectives"] = rec["collectives"]["total_bytes"]
    with fake_world(8):
        mesh = make_dev_mesh(2, 4, device_type="cpu")
        cfg = get_config("gemma2-9b", smoke=True).replace(
            n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=512)
        res["cell"] = run_cell_on(cfg, ShapeConfig("t", 64, 4, "train"), mesh)
    print("RESULT " + json.dumps(res))
    """
)


@pytest.fixture(scope="module")
def fake_run():
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", FAKE_SCRIPT], capture_output=True, text=True,
                          env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("RESULT ")][0]
    return json.loads(line[len("RESULT "):])


def test_cost_analysis_counts_one_device_s_flops(fake_run):
    assert fake_run["probe_local"] == [16, 4096, 896]
    assert fake_run["probe_flops"] == 2 * 256 * 4096 * 3584 * 14336 / 256
    assert fake_run["probe_collectives"] == 0


def test_cost_analysis_counts_no_bytes_for_views():
    """Views (view, t, slice, expand, detach, permute, ...) move no memory;
    an op that writes a tensor counts its input and output once each."""
    from repro_torch.launch.cost_analysis import measure

    x = torch.ones(64, 32)
    views = measure(lambda t: t.view(32, 64).t()[:, :16].expand(2, 64, 16).detach()
                    .reshape(2, 4, 16, 16).permute(0, 2, 1, 3), x)
    assert views["cost"]["bytes_per_device"] == 0 and views["cost"]["local_ops"] >= 6
    copy = measure(lambda t: t.t().contiguous(), x)
    assert copy["cost"]["bytes_per_device"] == 2 * 64 * 32 * 4


def test_dryrun_cell_record(fake_run):
    rec = fake_run["cell"]
    for key in ("memory", "cost", "collectives", "roofline", "model_flops_per_device",
                "useful_flop_ratio"):
        assert key in rec
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"] > 0
    assert rec["param_bytes_per_device"] == rec["param_bytes_from_specs"]
    assert rec["collectives"]["total_bytes"] > 0
    assert sum(rec["collectives"]["count_by_op"].values()) == sum(
        rec["collectives"]["comm_debug_counts"].values())
    assert rec["roofline"]["bottleneck"] in ("compute_s", "memory_s", "collective_s")
    assert rec["roofline"]["memory_s"] >= rec["roofline"]["memory_lower_s"] > 0
    assert "upper bound" in rec["roofline"]["memory_s_is"]
    assert rec["cost"]["flops_per_device"] > rec["model_flops_per_device"] > 0


def test_roofline_terms_bottleneck():
    from repro_torch.launch.cost_analysis import HBM_BW, PEAK_FLOPS, roofline_terms

    assert (PEAK_FLOPS, HBM_BW) == (989.4e12, 3.35e12)
    t = roofline_terms(PEAK_FLOPS, 100e9, 1e9)
    assert abs(t["compute_s"] - 1.0) < 1e-9 and t["bottleneck"] == "compute_s"
    assert roofline_terms(1e9, HBM_BW, 0)["bottleneck"] == "memory_s"
    assert roofline_terms(1e9, 1e9, 1e12)["bottleneck"] == "collective_s"


# --------------------------------------------------------------------------
# launch/: tests/test_launch.py's expectations, on the port.
# --------------------------------------------------------------------------
def test_plan_cells_accounting():
    from repro_torch.launch.dryrun import plan_cells

    cells = plan_cells()
    assert len(cells) == 64
    assert len({(a, s) for a, s, _ in cells}) == 32
    assert {a for a, s, _ in cells if s == "long_500k"} == {"mamba2-780m", "zamba2-2.7b"}
    assert {m for _, _, m in cells} == {"single_pod", "multi_pod"}


def test_batch_and_cache_shapes():
    from repro_torch.launch.steps import batch_shapes, cache_shapes

    b = batch_shapes(t_get_config("gemma2-9b"), SHAPES["train_4k"])
    assert b["inputs"].shape == (256, 4096) and b["targets"].shape == (256, 4096)
    b = batch_shapes(t_get_config("musicgen-medium"), SHAPES["prefill_32k"])
    assert "inputs" not in b and b["embeds"].shape == (32, 32768, 1536)
    b = batch_shapes(t_get_config("llama-3.2-vision-11b"), SHAPES["decode_32k"])
    assert b["inputs"].shape == (128, 1) and b["vision_states"].shape == (128, 1601, 4096)
    c = cache_shapes(t_get_config("gemma2-9b"), SHAPES["decode_32k"])
    assert c[0]["k"].shape == (21, 128, 4096, 8, 256)
    assert c[1]["k"].shape == (21, 128, 32768, 8, 256)
    c = cache_shapes(t_get_config("mamba2-780m"), SHAPES["long_500k"])
    assert c[0]["state"].shape == (48, 1, 48, 128, 64)
    c = cache_shapes(t_get_config("zamba2-2.7b"), SHAPES["long_500k"])
    assert c[5]["sa"]["k"].shape == (9, 1, 524288, 32, 80)


def test_param_shapes_match_reference():
    from repro_torch.launch.steps import param_shapes
    from repro_torch.tree import tree_leaves

    for arch in ("gemma2-9b", "zamba2-2.7b"):
        import jax

        want = [tuple(x.shape) for x in jax.tree_util.tree_leaves(_ref_shapes(arch))]
        assert [x.shape for x in tree_leaves(param_shapes(t_get_config(arch)))] == want


def _record(arch, shape, mesh):
    return {"arch": arch, "shape": shape, "mesh": mesh, "n_chips": 256,
            "memory": {"peak_bytes": 8 * 2**30},
            "cost": {"flops_per_device": 1.0e12},
            "collectives": {"total_bytes": 1.0e9},
            "roofline": {"compute_s": 2.0e-3, "memory_s": 1.0e-3, "collective_s": 5.0e-4,
                         "bottleneck": "compute_s"},
            "model_flops_per_device": 0.8e12, "useful_flop_ratio": 0.8}


def test_roofline_report_reads_records(tmp_path):
    from repro_torch.launch.dryrun import plan_cells
    from repro_torch.launch.roofline import delta_table, load, roofline_fraction, table

    cells = plan_cells()
    for arch, shape, mesh in cells:
        (tmp_path / f"{arch}__{shape}__{mesh}.json").write_text(
            json.dumps(_record(arch, shape, mesh)))
    (tmp_path / "FAIL__x__y__z.json").write_text("{}")
    results = load(str(tmp_path))
    assert len(results) == len(cells)
    lines = table(results)
    assert any("gemma2-9b" in line for line in lines)
    assert any("skipped(full-attention)" in line for line in lines)
    rec = next(iter(results.values()))
    assert roofline_fraction(rec) == pytest.approx(0.8e12 / 989.4e12 / 2.0e-3)
    assert len(delta_table(results, results, sorted(results))) == 2 + 3 * len(cells)


def test_train_launcher_on_a_dev_mesh(tmp_path, capsys):
    """--mesh dev outside torchrun: a one-rank group and a (1, 1) mesh on the
    CPU, destroyed after; two finite steps and a checkpoint of the gathered
    parameters that restores into the meshless tree. (The launcher's data
    come from two ingest workers, whose order varies between runs, so its
    loss is not compared across runs; the mesh steps are held to the
    meshless ones above.)"""
    import math

    import torch.distributed as dist

    from repro_torch.checkpointing import CheckpointManager
    from repro_torch.launch.train import main
    from repro_torch.models import get_config, init_params
    from repro_torch.tree import tree_leaves

    ckpt = tmp_path / "ckpt"
    main(["--smoke", "--device", "cpu", "--steps", "2", "--ckpt-every", "2", "--mesh", "dev",
          "--ckpt-dir", str(ckpt)])
    out = capsys.readouterr().out.splitlines()
    assert not dist.is_initialized()
    assert any("mesh={'data': 1, 'model': 1}" in line for line in out)
    steps = [line for line in out if line.startswith("step")]
    assert len(steps) == 2 and all(math.isfinite(float(line.split()[3])) for line in steps)
    template = init_params(get_config("llcysa-analytics-100m", smoke=True),
                           torch.Generator().manual_seed(1), device="cpu")
    step, restored = CheckpointManager(str(ckpt)).restore_latest(template)
    assert step == 2
    assert all(a.shape == b.shape and a.dtype == b.dtype and not torch.equal(a, b)
               for a, b in zip(tree_leaves(restored), tree_leaves(template))
               if a.numel() > 1 and a.abs().sum() > 0)
