from yugabyte_tpu_torch.parallel.mesh import Mesh, make_mesh
from yugabyte_tpu_torch.parallel.dist_compact import (distributed_compact,
                                                      pooled_merge_gc)
