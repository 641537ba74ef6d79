"""Serving layer of the PyTorch port: the vector-search service facade."""

from repro_torch.serve.vector_service import ServiceConfig, VectorSearchService

__all__ = ["ServiceConfig", "VectorSearchService"]
