"""Run configuration: visrag_tpu's jax-free config dataclasses, shared as
they are (the port reads the same YAML and dotlist overrides)."""

from visrag_tpu.config import EvalConfig, ModelConfig, load_config

__all__ = ["EvalConfig", "ModelConfig", "load_config"]
