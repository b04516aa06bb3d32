"""Data-parallel and restart-parallel training on ``torch.distributed``:
the process-group mesh (``mesh``) and the SPMD trainers (``sharded_em``)."""
