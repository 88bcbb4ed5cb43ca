"""The multi-device layer on torch.distributed: worlds of ranks and their
collectives (`group`), GOP sharding with the payload gather (`gops`) and
tile sharding within a frame with halo exchange (`tiles`)."""
