"""Model substrate of the port: layers, the dense transformer, cache ops,
and the family dispatcher."""
from .model_zoo import bind
