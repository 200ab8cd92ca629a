"""Distribution over processes: port of unipre3d_tpu/parallel/."""

from unipre3d_tpu_torch.parallel.mesh import (make_mesh, replicate,
                                              tp_matched_paths)
from unipre3d_tpu_torch.parallel.distributed import (all_reduce_mean,
                                                     maybe_initialize,
                                                     process_count,
                                                     process_index, synced)
