"""Host preprocessing: the port's own copy of visrag_tpu's jax-free
pipeline (slicing, resizing, uint8 patches, tokenization); `device`
finishes the raw batch on the GPU."""

from .pipeline import PipelineConfig, build_encode_batch, pick_patch_bucket
from .tokenize import MockTokenizer

__all__ = ["MockTokenizer", "PipelineConfig", "build_encode_batch",
           "pick_patch_bucket"]
