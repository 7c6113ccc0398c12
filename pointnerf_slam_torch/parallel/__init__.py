"""Scale-out of the mapping workload: the ray budget split over a
torch.distributed process group (mapping.py) and several scenes mapped by
one step (multiscene.py)."""

from .mapping import (DataGroup, all_reduce_grads, data_devices,
                      make_mesh, make_sharded_mapping_step,
                      make_shardmap_mapper_step, resolve_data_devices)
from .multiscene import make_multiscene_mapper_step, stack_scenes
