"""Data plane of the LM harness: the token pipeline and the C-SAW walk
corpus (the port of ``repro.data``)."""
from repro_torch.data.pipeline import PipelineState, TokenPipeline
from repro_torch.data.walk_corpus import build_walk_corpus

__all__ = ["PipelineState", "TokenPipeline", "build_walk_corpus"]
