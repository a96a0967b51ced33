"""Problem providers — the lazy column-generation seam.

Mirror of reference ``src/algorithm/two_phase/matrix_provider``: a
:class:`MatrixProvider` is a read-only, possibly *virtual* view of a
standard-form LP — columns are generated on demand and never materialized as
one big host matrix.  Custom providers (e.g. the network kit) plug in here.

The device twist: every provider can *lower* itself to dense device arrays
(:meth:`MatrixProvider.to_arrays`), which is what the device simplex consumes;
providers with huge column counts can instead lower shard-by-shard for the
column-sharded engine in :mod:`relp_tpu.parallel`.
"""

from relp_tpu.providers.base import MatrixProvider, PartialInitialBasis, FullInitialBasis
from relp_tpu.providers.column import Column, SparseColumn, SlackColumn, TwoSlackColumn, IdentityColumn
from relp_tpu.providers.matrix_data import MatrixData
from relp_tpu.providers.filter import RemoveRows

__all__ = [
    "MatrixProvider",
    "PartialInitialBasis",
    "FullInitialBasis",
    "Column",
    "SparseColumn",
    "SlackColumn",
    "TwoSlackColumn",
    "IdentityColumn",
    "MatrixData",
    "RemoveRows",
]
