"""The LLCySA store, ported: host-side schema, keys, filter programs,
batching and planning (numpy copies of the reference's modules), the
host EventStore with its query processor and server-side iterator stack,
and the device ingest plane, query and aggregation paths in PyTorch."""
from . import (  # noqa: F401
    batching, filter, iterators, keypack, planner, query, scan, schema, store, tables,
)
from .batching import AdaptiveBatcher, iter_batches, run_batched_query  # noqa: F401
from .filter import And, Cmp, Eq, In, Match, Node, Not, Or, TrueNode  # noqa: F401
from .iterators import (  # noqa: F401
    AggregateBlock,
    AggregateResult,
    AggregateSpec,
    CombinerIterator,
    FilterIterator,
    IteratorStack,
    ProjectingIterator,
    ScanIterator,
    VersioningIterator,
    merge_aggregate_blocks,
    resolve_grouping,
)
from .ingest import check_shard_guidance  # noqa: F401
from .planner import QueryPlan, plan_query  # noqa: F401
from .query import QueryProcessor, QueryStats  # noqa: F401
from .schema import EventSchema, FieldSpec, web_proxy_schema  # noqa: F401
from .store import EventStore  # noqa: F401
