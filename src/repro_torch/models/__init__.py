"""Model substrate of the port: layers, the dense transformer, the Mamba-2
and Zamba2 families, cache ops, and the family dispatcher."""
from .model_zoo import bind, pack_sc_weights
