"""The program's models, built from a configuration file at its widths and
filled with the benchmark's weights (portbench/weights.py).

`tiny=True` builds the program's small test presets instead (CPU tests
only); the configuration file's widths are what every chip run uses.
"""

from __future__ import annotations

import dataclasses

import torch

from .weights import make_weights

VIT_KEYS = ("patch_size", "embed_dim", "depth", "num_heads", "mlp_dim",
            "pos_grid", "ln_eps")
RESAMPLER_KEYS = ("num_queries", "embed_dim", "kv_dim", "num_heads",
                  "ln_eps")
LLM_KEYS = ("vocab_size", "hidden_size", "intermediate_size",
            "num_hidden_layers", "num_attention_heads", "num_key_value_heads",
            "rms_norm_eps", "rope_theta", "scale_emb", "dim_model_base",
            "scale_depth", "max_position_embeddings")


def _fields(c) -> dict:
    return {k: v for k, v in dataclasses.asdict(c).items()
            if not isinstance(v, (torch.dtype, dict))}


def retriever_config(config: dict, tiny: bool, quant: str = "none"):
    """→ (VisRAGRetConfig, the reference's config dict, pipeline dict)."""
    from visrag_tpu_torch.models.minicpm import MiniCPMConfig
    from visrag_tpu_torch.models.minicpmv import MiniCPMVConfig
    from visrag_tpu_torch.models.resampler import ResamplerConfig
    from visrag_tpu_torch.models.siglip_vit import SiglipViTConfig
    from visrag_tpu_torch.models.visrag_ret import VisRAGRetConfig
    if tiny:
        cfg = VisRAGRetConfig.tiny()
        bb = cfg.backbone
        pipe = {"scale_resolution": 8, "max_slice_nums": 9, "seq_len": 64,
                "max_patches": 64}
    else:
        v = config["vision"]
        bb = MiniCPMVConfig(
            llm=MiniCPMConfig(**{k: config["llm"][k] for k in LLM_KEYS}),
            vit=SiglipViTConfig(**{k: v[k] for k in VIT_KEYS}),
            resampler=ResamplerConfig(**{k: config["resampler"][k]
                                         for k in RESAMPLER_KEYS}),
            query_num=config["query_num"],
            scale_resolution=config["pipeline"]["scale_resolution"])
        cfg = VisRAGRetConfig(backbone=bb, pooling=config["pooling"])
        pipe = dict(config["pipeline"])
    if quant != "none":
        bb = dataclasses.replace(
            cfg.backbone, vit=dataclasses.replace(cfg.backbone.vit,
                                                  quant=quant),
            llm=dataclasses.replace(cfg.backbone.llm, quant=quant))
        cfg = dataclasses.replace(cfg, backbone=bb)
    bb = cfg.backbone
    ref = {"vision": _fields(bb.vit), "resampler": _fields(bb.resampler),
           "llm": _fields(bb.llm), "pipeline": pipe}
    return cfg, ref, pipe


def retriever(config: dict, seed: int, device, tiny: bool = False):
    """The VisRAG-Ret encoder with the seed's weights → (model, reference
    config, PipelineConfig of the program)."""
    from visrag_tpu_torch.models.visrag_ret import VisRAGRet
    from visrag_tpu_torch.preprocess import PipelineConfig
    cfg, ref, pipe = retriever_config(config, tiny)
    with torch.device("meta"):
        model = VisRAGRet(cfg)
    dtype = cfg.backbone.llm.dtype
    make_weights(model, seed, device, dtype)
    bb = cfg.backbone
    pcfg = PipelineConfig(
        seq_len=pipe["seq_len"], query_num=bb.query_num,
        patch_size=bb.vit.patch_size, src_grid=bb.vit.pos_grid,
        scale_resolution=pipe["scale_resolution"],
        max_slice_nums=pipe["max_slice_nums"],
        max_patches=pipe["max_patches"])
    return model, ref, pcfg


def share_weights(model, donor):
    """Give `model` (built on the meta device) the donor's parameters,
    leaf for leaf by name. → model in eval mode."""
    params = dict(donor.named_parameters())
    for mod_name, mod in model.named_modules():
        for pname, p in list(mod._parameters.items()):
            if p is None:
                continue
            full = f"{mod_name}.{pname}" if mod_name else pname
            mod._parameters[pname] = params[full]
    return model.eval()


def retriever_int8(config: dict, donor, tiny: bool = False):
    """The program's w8a8 encoder (its int8 path) on the donor's weights:
    the control of the retriever cells."""
    from visrag_tpu_torch.models.visrag_ret import VisRAGRet
    cfg, _, _ = retriever_config(config, tiny, quant="int8")
    with torch.device("meta"):
        model = VisRAGRet(cfg)
    return share_weights(model, donor)


def qwen_config(config: dict, tiny: bool):
    """→ (Qwen25VLConfig, the reference's config dict, token ids)."""
    from visrag_tpu_torch.models.qwen25_vl import Qwen25VLConfig
    if tiny:
        cfg = Qwen25VLConfig.tiny()
        ids = {"image_token_id": cfg.image_token_id,
               "vision_start_token_id": cfg.vision_start_token_id,
               "vision_end_token_id": 121, "im_start_id": 122,
               "eos_token_id": 123}
        text = _fields(cfg.text)
        text.update(rope_scaling={"mrope_section":
                                  list(cfg.text.mrope_section)},
                    image_token_id=cfg.image_token_id)
        ref = dict(text, vision_config=_fields(cfg.vision))
        return cfg, ref, ids, 100
    cfg = Qwen25VLConfig.from_hf(config)
    ids = {k: config[k] for k in ("image_token_id", "vision_start_token_id",
                                  "vision_end_token_id", "eos_token_id")}
    return cfg, config, ids, config["bos_token_id"]


def qwen(config: dict, seed: int, device, tiny: bool = False):
    """Qwen2.5-VL with the seed's weights → (model, reference config,
    token ids, size of the text vocabulary the stand-in tokenizer uses)."""
    from visrag_tpu_torch.models.qwen25_vl import Qwen25VL
    cfg, ref, ids, text_vocab = qwen_config(config, tiny)
    with torch.device("meta"):
        model = Qwen25VL(cfg)
    make_weights(model, seed, device, cfg.text.dtype)
    return model, ref, ids, text_vocab
