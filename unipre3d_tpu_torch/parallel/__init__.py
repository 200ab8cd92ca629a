"""Distribution over processes and tensor parallelism: port of
unipre3d_tpu/parallel/ (the 1-D data mesh and the 2-D (data, model) grid
with Megatron splits; parallel/tensor.py holds the collectives GSPMD
inserts in JAX)."""

from unipre3d_tpu_torch.parallel.mesh import (TP_RULES, gathered_state_dict,
                                              make_mesh, replicate,
                                              tp_matched_paths)
from unipre3d_tpu_torch.parallel.distributed import (all_reduce_mean, grid,
                                                     maybe_initialize,
                                                     process_count,
                                                     process_index, synced)
