"""Multi-device decoding of the port: tensor-parallel groups and their
collectives (``mesh``), the placement of the decoder's weights and KV
caches over a group (``spmd``), the two-stage vision / decoder pipeline
(``pipeline``) and the multi-rank dry run (``dryrun``).  Counterpart of
``minigpt4_tpu/parallel/``."""

from .mesh import TPGroup, all_gather_tiled, init_tp, pmax, psum

__all__ = ["TPGroup", "all_gather_tiled", "init_tp", "pmax", "psum"]
