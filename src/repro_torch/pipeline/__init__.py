"""The big-data pipeline around the store (paper §II): staged source files,
a master ingest process feeding a partitioned queue, parallel ingest
workers, and the event->token bridge that feeds the analytics LM.

Fault tolerance beyond the paper: lease-based work claims with heartbeats,
straggler re-queue, elastic worker pools, file-grained retry.
"""
from .queue import FileTask, MasterIngestQueue  # noqa: F401
from .sources import SyntheticWebProxySource, parse_web_proxy_line  # noqa: F401
from .workers import IngestWorkerPool  # noqa: F401
from .tokenizer import EventTokenizer  # noqa: F401
