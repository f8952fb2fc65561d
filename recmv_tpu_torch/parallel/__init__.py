"""Several ranks for one scene's training step (counterpart of
``recmv_tpu/parallel``): the rank mesh, the work split and the process
groups (``mesh``), and a one-step dry run (``dryrun``)."""

from .mesh import (FrameShare, Mesh, frame_share, init_parallel, make_mesh, pad_to_devices,
                   ray_share, shard_rays, spawn)
