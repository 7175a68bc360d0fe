"""Scale-out: device meshes for DP batches (``mesh``) and cohort runs over a
torch.distributed key-value store (``multihost``)."""
