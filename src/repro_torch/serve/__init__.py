"""Serving layer of the PyTorch port: the vector-search service facade and
the language-model engine."""

from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.vector_service import ServiceConfig, VectorSearchService

__all__ = ["Engine", "ServeConfig", "ServiceConfig", "VectorSearchService"]
