"""Host preprocessing is visrag_tpu's jax-free pipeline, shared as it is
(slicing, resizing, uint8 patches, tokenization); `device` finishes the
raw batch on the GPU."""

from visrag_tpu.preprocess.pipeline import (PipelineConfig,
                                            build_encode_batch,
                                            pick_patch_bucket)
from visrag_tpu.preprocess.tokenize import MockTokenizer

__all__ = ["MockTokenizer", "PipelineConfig", "build_encode_batch",
           "pick_patch_bucket"]
