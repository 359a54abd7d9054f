"""Multi-process scaling on torch.distributed (``sharding``)."""
