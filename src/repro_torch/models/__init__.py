"""Model substrate of the port: layers, the transformer (dense, moe, vlm
and audio; its MoE FFN in ``moe``), the Mamba-2 and Zamba2 families,
cache ops, and the family dispatcher."""
from .model_zoo import bind, pack_sc_weights
