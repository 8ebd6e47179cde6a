"""The multi-device layer on `torch.distributed` (counterpart of
`reconstruction_tpu/parallel/`): the (frame, pair, tile) mesh, process
groups and a local launcher, pair-sharded stereo, the tile-sharded
refine, distributed bundle adjustment, cloud fusion and the z-sharded
Poisson multigrid."""
