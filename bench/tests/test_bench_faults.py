"""The comparison that decides ``correct`` fails when the timed path is
broken underneath: each fault a cell can have, and the control (the
reference in the program's place with a guarantee broken), on the CPU at
small sizes; the control also at the cells' own sizes on the card."""
import contextlib
import json
import time

import pytest
import torch

from bench import faults, harness
from bench.tests.conftest import ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
LOOPS = {w["name"]: harness.resolve(w["name"]).traffic["loop"] for w in MANIFEST["workloads"]}
INGEST = [n for n, d in LOOPS.items() if d == "ingest_epochs"]
SERVE = [n for n, d in LOOPS.items() if d == "analysts"]
CASES = [(c, f) for c in INGEST for f in (
    faults.append_leaves_state_unchanged, faults.ingest_drops_half_the_batch,
    faults.append_alters_a_code, faults.fold_skips_the_combine,
    faults.minor_leaves_runs_unsorted, faults.publish_skips_the_seal)] + \
    [(c, f) for c in SERVE for f in (
        faults.steps_return_nothing, faults.scans_read_half_the_groups,
        faults.results_alter_a_count)]


def _run(name, seed, seconds, device, scale=None, fault=None, answers_hook=None):
    cell = harness.resolve(name)
    with fault() if fault else contextlib.nullcontext():
        return harness.run_cell(cell, seed, seconds, False, device, time.perf_counter(),
                                scale=scale, answers_hook=answers_hook)


def test_every_cell_has_its_faults():
    assert INGEST and SERVE and set(INGEST + SERVE) == set(LOOPS)


@pytest.mark.parametrize("name,fault", CASES, ids=lambda x: getattr(x, "__name__", x))
def test_fault_makes_the_run_incorrect(name, fault, tiny):
    out = _run(name, 11, 1.0, torch.device("cpu"), tiny, fault)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_order_and_combining_are_checked_apart(tiny):
    """An uncombined base keeps every row, key and sum: only the check of
    combining sees it. Unsorted runs are seen by the check of order."""
    checks = _run(INGEST[0], 13, 1.0, torch.device("cpu"), tiny,
                  faults.fold_skips_the_combine)["checks"]
    assert checks["combined_repeats_off"]["value"] > 0
    assert all(checks[k]["value"] == 0 for k in ("ev_rows_off", "ix_keys_off", "ag_sums_off"))
    checks = _run(INGEST[0], 13, 1.0, torch.device("cpu"), tiny,
                  faults.minor_leaves_runs_unsorted)["checks"]
    assert checks["level_order_off"]["value"] > 0


@pytest.mark.parametrize("name", SERVE)
def test_control_bucketed_answers_is_incorrect(name, tiny):
    out = _run(name, 12, 1.0, torch.device("cpu"), tiny,
               answers_hook=faults.bucketed_answers(3600))
    assert out["correct"] is False and out["checks"]["counts_off"]["value"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 202, 2**31 + 303])
@pytest.mark.parametrize("name", INGEST + SERVE)
def test_control_at_cell_size(name, seed, cuda_device, capsys):
    """The control on the card at the cell's size and window: the numbers
    it reads are the upper readings PERF.md gives."""
    seconds = MANIFEST["run_seconds"]
    if name in INGEST:
        out = _run(name, seed, seconds, cuda_device, fault=faults.publish_skips_the_seal)
    else:
        out = _run(name, seed, seconds, cuda_device,
                   answers_hook=faults.bucketed_answers(3600))
    with capsys.disabled():
        print(f"\ncontrol {name} seed {seed}: " + json.dumps(
            {k: c["value"] for k, c in out["checks"].items()}))
    assert out["correct"] is False
