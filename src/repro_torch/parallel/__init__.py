"""Distribution (port of ``repro/parallel``): logical-axis sharding rules
on a ``DeviceMesh``, the activation-sharding scope and the pipeline-
parallel schedule over ``torch.distributed``."""
from .sharding import batch_pspecs, cache_pspecs, named, param_pspecs
