"""Architecture configs of the port (one module per assigned arch) and the
``--arch`` registry: data only, copied from ``repro/configs``."""
