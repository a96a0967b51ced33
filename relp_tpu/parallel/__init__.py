"""Scale-out: device meshes, column sharding, scenario batching.

The reference is single-threaded; all parallelism here is new design
(SURVEY.md section 2, "Parallelism & communication" checklist):

* :mod:`relp_tpu.parallel.mesh` — mesh construction helpers.
* :mod:`relp_tpu.parallel.sharded` — the constraint store sharded by columns
  across the mesh ("tp" for LPs): pricing runs as a local scan per shard and
  XLA inserts the all-reduce argmax across devices (GSPMD via sharding
  annotations — the jax-native alternative to hand-written collectives).
* :mod:`relp_tpu.parallel.batch` — vmapped scenario batches ("dp" for LPs):
  many LPs advance in lockstep, each with its own state, sharded over the
  batch axis.
"""

from relp_tpu.parallel.mesh import make_mesh, default_mesh
from relp_tpu.parallel.sharded import shard_problem, sharded_run_chunk
from relp_tpu.parallel.batch import batched_run_chunk, make_batch_state

__all__ = [
    "make_mesh",
    "default_mesh",
    "shard_problem",
    "sharded_run_chunk",
    "batched_run_chunk",
    "make_batch_state",
]
