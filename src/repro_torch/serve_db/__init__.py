"""Concurrent query-serving plane: many client sessions streaming result
batches over ONE shared DistIngestPlane on one card, with background
compaction off the query path; the port of the reference's serve_db
package."""
from .compactor import BackgroundCompactor  # noqa: F401
from .profile import QueryProfile, ttfr_event_probe  # noqa: F401
from .scheduler import FairScheduler, QueryEntry, TurnQuantum  # noqa: F401
from .service import QueryService  # noqa: F401
from .session import QuerySession, ResultBatch, StreamingQuery  # noqa: F401
