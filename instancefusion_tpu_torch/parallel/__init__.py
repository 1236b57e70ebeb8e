"""The sharded map on ``torch.distributed``: rank groups and collectives
(``mesh``), the slab-sharded block map and its distributed ops (``shard``)."""
