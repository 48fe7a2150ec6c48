"""Multi-process parallelism of the port on ``torch.distributed``: process
start-up (:mod:`.distributed`) and the ('data', 'seq') mesh with its
collectives (:mod:`.mesh`)."""
