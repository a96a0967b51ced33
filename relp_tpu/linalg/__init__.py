"""Linear algebra primitives.

Two halves:

* :mod:`relp_tpu.linalg.sparse` — host-side exact sparse vectors/matrices
  (mirror of reference src/data/linear_algebra: sorted-tuple sparse storage
  with typed row/column-major ordering).
* :mod:`relp_tpu.linalg.device` — padding and layout helpers for lowering
  exact host data to dense padded device arrays (new, device-specific).
"""

from relp_tpu.linalg.sparse import SparseVector, SparseColumnMatrix
from relp_tpu.linalg.device import pad_to_multiple, pad_matrix, pad_vector

__all__ = [
    "SparseVector",
    "SparseColumnMatrix",
    "pad_to_multiple",
    "pad_matrix",
    "pad_vector",
]
