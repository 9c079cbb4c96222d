"""The paper's own system configuration: the LLCySA pipeline (store +
ingest + query) and the ~100M-param analytics LM over tokenized events;
a copy of the reference's configs/llcysa.py.

Paper reference points (§IV): an 8-node Accumulo instance for queries;
adaptive batching defaults k0=10, c=1.5, Tmin=1s, Tmax=30s; planner
threshold w empirically derived (default 10)."""
from dataclasses import dataclass

from .base import ModelConfig


@dataclass(frozen=True)
class PipelineConfig:
    n_shards: int = 8  # "tablet servers" (paper: 8-node instance)
    n_ingest_workers: int = 4
    flush_rows: int = 32768
    max_runs: int = 8
    agg_bucket_seconds: int = 3600
    batch_rows: int = 4096
    planner_w: float = 10.0
    k0: float = 10.0
    c: float = 1.5
    t_min: float = 1.0
    t_max: float = 30.0


PIPELINE = PipelineConfig()

# ~100M-param event LM (d=768, 12L).
CONFIG = ModelConfig(
    name="llcysa-analytics-100m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=2048,
    vocab_size=32768,
    layer_pattern=("global",),
    act="silu",
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=2048)
