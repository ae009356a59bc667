"""Multi-device paths of the port: tensor-parallel groups, the (dp, tp)
mesh and the collectives (``mesh``), the placement of the decoder's weights
and KV caches (``spmd``) and of the vision encoder (``sharding``) over a
group, the rank-0 controller of serving over tp ranks (``controller``), the
two-stage vision / decoder pipeline (``pipeline``) and the multi-rank dry
run (``dryrun``).  Counterpart of ``minigpt4_tpu/parallel/``."""

from .mesh import (Mesh, TPGroup, all_gather_tiled, copy_to_tp, init_tp, make_mesh, pmax, psum,
                   reduce_from_tp)

__all__ = ["Mesh", "TPGroup", "all_gather_tiled", "copy_to_tp", "init_tp", "make_mesh", "pmax",
           "psum", "reduce_from_tp"]
