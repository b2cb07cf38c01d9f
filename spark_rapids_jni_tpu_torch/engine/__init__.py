"""Query-plan engine on one device: logical plan DAG, optimizer, executor,
plan/segment/build caches.

The port of ``spark_rapids_jni_tpu/engine``.  Build a
``Scan/Filter/Project/Join/Aggregate/Sort/Limit`` DAG (plan.py, a copy of
the JAX package's: the same plan serializes to the same bytes in both, so
``deserialize(jax_plan.serialize())`` moves a plan across), let
``optimize`` prune projections and push predicates into scan row-group
pruning (optimizer.py), then ``execute`` it on the ops/io layers
(executor.py) on ``device`` (default ``"cuda"``).  Filter/Project/Aggregate
chains between breakers run as compiled segments cached by (fingerprint,
shape-class) in ``SEGMENT_CACHE`` (segment.py), and chunked scans stream
double-buffered, partials accumulating on the device with no per-chunk
sync; on a card each chunk's compressed pages are decoded on the device
inside its segment (``config.device_decode`` pins a route).
``PlanCache`` lets repeat queries skip optimization.

``optimize(plan, distribute=True)`` places the Exchanges a mesh of
``config.shards`` shards needs, and the executor runs them through the
exchange layer (``parallel/``): hash shuffles with a halved-chunk and a
spilled rung, and broadcasts.  Scans read Parquet and ORC.
``config.fuse_exchange`` runs a partial/final aggregate sandwich as one
fused stage (``segment.FusedStage``), and ``config.aqe`` turns on adaptive
execution (``adaptive``: the broadcast flip, the hot-key skew split and
profile-warmed planning).

``scheduler.SCHEDULER`` admits the bridge's concurrent ``PLAN_EXECUTE``
sessions and interleaves their chunks; ``execute(session=...)`` runs a plan
as one of them.
"""

from .plan import (  # noqa: F401
    Aggregate,
    Exchange,
    Filter,
    Join,
    Limit,
    PlanNode,
    Project,
    Scan,
    Sort,
    TopK,
    col,
    deserialize,
    expr_columns,
    from_dict,
    lit,
    node_label,
)
from .optimizer import optimize, output_names  # noqa: F401
from .verify import (  # noqa: F401
    PlanVerificationError,
    SchemaResolver,
    verify,
)
from .executor import execute, new_stats  # noqa: F401
from .cache import (  # noqa: F401
    BUILD_CACHE,
    RESULT_CACHE,
    BuildCache,
    CompiledPlan,
    PlanCache,
    ResultCache,
    data_version,
)
from .scheduler import (  # noqa: F401
    SCHEDULER,
    QuerySession,
    Scheduler,
)
from .explain import ExplainReport, explain_analyze  # noqa: F401
from .segment import (  # noqa: F401
    FUSED_STAGE_CACHE,
    SEGMENT_CACHE,
    CompiledFusedStage,
    CompiledSegment,
    FusedStage,
    Segment,
    SegmentCache,
    build_segment,
    build_stream_segment,
)
from . import adaptive  # noqa: F401
