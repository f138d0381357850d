"""Device-mesh runtime (counterpart of ``snngp/parallel``): sharded Gram
construction, blocked / in-place / distributed Cholesky, the distributed
ML-II step. A mesh is one process over a grid of ``torch.device``s, or
after ``init_distributed`` the ranks of a ``torch.distributed`` group
(:mod:`snngp_torch.parallel.mesh`)."""

from snngp_torch.parallel.mesh import get_mesh, device_count
from snngp_torch.parallel.gram import sharded_gram
from snngp_torch.parallel.cholesky import distributed_cholesky
from snngp_torch.parallel.mlii import (sharded_aug_gram,
                                       distributed_mlii_value_and_grad)

__all__ = ["get_mesh", "device_count", "sharded_gram",
           "distributed_cholesky", "sharded_aug_gram",
           "distributed_mlii_value_and_grad"]
