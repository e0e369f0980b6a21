"""radixjoin — a vectorized join-execution engine for accelerators.

A from-scratch JAX/XLA implementation of the capability set of the
SIGMOD 2025 contest reference engine (cliarie/radix-join): it executes
PostgreSQL-optimized hash-join pipelines (``Plan`` trees of scan + equi-join
nodes over 8 KiB-paged columnar tables) and returns exact row multisets.

Unlike the reference C++ interpreter (which materializes every intermediate
row as a vector of variants, see reference src/execute.cpp:12), this
engine keeps all data as dense typed arrays + validity masks end-to-end and
lowers each join to vectorized device kernels (sort/partition, search-probe,
count-then-materialize, late gather materialization).

Top-level API (mirrors reference include/plan.h:337-344):

    ctx = build_context()
    result: ColumnarTable = execute(plan, ctx)
    destroy_context(ctx)
"""

import jax as _jax

# The engine operates on INT64 keys/payloads and bit-exact FP64 (carried as
# bitcast int64 on device); 64-bit types must be enabled before any tracing.
_jax.config.update("jax_enable_x64", True)

from .dtypes import DataType, NULL  # noqa: E402
from .plan.ir import Plan, PlanNode, ScanNode, JoinNode  # noqa: E402
from .storage.columnar import Column, ColumnarTable  # noqa: E402
from .engine import build_context, destroy_context, execute, execute_many  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "DataType",
    "NULL",
    "Plan",
    "PlanNode",
    "ScanNode",
    "JoinNode",
    "Column",
    "ColumnarTable",
    "build_context",
    "destroy_context",
    "execute",
    "execute_many",
]
