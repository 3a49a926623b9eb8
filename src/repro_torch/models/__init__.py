"""Model substrate of the port: the layers, the RG-LRU block, the decoder
stack and the ``Model`` serving API, with the reference's names."""
from .layers import ParallelCtx
from .model import Model, build_model
