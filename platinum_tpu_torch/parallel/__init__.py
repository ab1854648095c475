"""Multi-device rendering over torch.distributed: the rank mesh and its
collectives, pixel and sample sharding, geometry sharding, multi-host."""
