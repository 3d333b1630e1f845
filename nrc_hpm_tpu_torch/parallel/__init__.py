"""Sharded rendering over ``torch.distributed`` (``sharding.py``) and the
multi-process worker (``multihost.py``)."""
