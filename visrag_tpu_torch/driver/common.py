"""Shared driver plumbing: model, tokenizer and pipeline construction.

Counterpart of visrag_tpu/driver/common.py (build_visrag_ret,
build_tokenizer). Without weights in the repository the model is
initialised at random from a seed, with the JAX package's initialiser
families so that activations stay finite through the 40 MUP-scaled LM
layers:

  * linear and patch-embed weights: truncated normal with std
    1/sqrt(out_features) (flax lecun_normal reads fan-in from the first
    axis of the JAX package's (out, in) layout); biases zero;
  * norms: weight one, bias zero;
  * token embeddings: normal, std 1/sqrt(hidden);
  * ViT pos_embed: normal(0.02); resampler query: truncated normal(0.02);
    resampler in_proj: xavier uniform; resampler proj: normal(E^-1/2);
    the resampler's query pos embed: the fixed 8×8 2-D sin-cos table.

Full width is bf16, `tiny` fp32. `ModelConfig.remat` switches on
whole-block recomputation in the ViT and the LM when gradients are on.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..config import ModelConfig
from ..models.common import LayerNorm, RMSNorm, get_2d_sincos_pos_embed
from ..models.resampler import Resampler
from ..models.siglip_vit import SiglipViT
from ..models.visrag_ret import VisRAGRet, VisRAGRetConfig
from ..preprocess import MockTokenizer, PipelineConfig


_NO_CHECKPOINTS = ("loading a checkpoint into visrag_tpu_torch is not ported "
                   "yet (the weights and tokenizer files are not in the "
                   "repository); run without --checkpoint for random weights")


def build_tokenizer(checkpoint: str):
    """The deterministic MockTokenizer; a checkpoint's own tokenizer comes
    with checkpoint loading."""
    if checkpoint:
        raise NotImplementedError(_NO_CHECKPOINTS)
    return MockTokenizer()


def _trunc_normal_(t, std, gen):
    # flax truncated normal: ±2σ of the underlying normal, rescaled so the
    # truncated distribution keeps the requested std (lecun) or not (query)
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                 generator=gen)


@torch.no_grad()
def init_weights_(model: nn.Module, gen: torch.Generator) -> None:
    """Random init in place of VisRAGRet or any of its submodules, in
    module order (reproducible per seed)."""
    for module in model.modules():
        if isinstance(module, (LayerNorm, RMSNorm)):
            module.weight.fill_(1.0)
            if isinstance(module, LayerNorm):
                module.bias.zero_()
        elif isinstance(module, nn.Linear):
            std = module.weight.shape[0] ** -0.5 / 0.87962566103423978
            _trunc_normal_(module.weight, std, gen)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.Embedding):
            module.weight.normal_(0.0, module.weight.shape[1] ** -0.5,
                                  generator=gen)
        elif isinstance(module, SiglipViT):
            module.pos_embed.normal_(0.0, 0.02, generator=gen)
        elif isinstance(module, Resampler):
            c = module.cfg
            _trunc_normal_(module.query, 0.02, gen)
            grid = int(round(c.num_queries ** 0.5))
            module.pos_embed.copy_(torch.from_numpy(
                get_2d_sincos_pos_embed(c.embed_dim, grid, grid)))
            nn.init.xavier_uniform_(module.attn.in_proj_weight, generator=gen)
            module.attn.in_proj_bias.zero_()
            module.proj.normal_(0.0, c.embed_dim ** -0.5, generator=gen)


def build_visrag_ret(model_cfg: ModelConfig, *, tiny: bool = False,
                     device="cuda", seed: int = 0):
    """→ (model in eval mode on `device`, PipelineConfig)."""
    if model_cfg.checkpoint:
        raise NotImplementedError(_NO_CHECKPOINTS)
    cfg = VisRAGRetConfig.tiny() if tiny else VisRAGRetConfig(
        pooling=model_cfg.pooling, normalize=model_cfg.normalize)
    bb = cfg.backbone
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        bb, vit=dataclasses.replace(bb.vit, remat=model_cfg.remat),
        llm=dataclasses.replace(bb.llm, remat=model_cfg.remat)))
    device = torch.device(device)
    with torch.device("meta"):
        model = VisRAGRet(cfg)
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    init_weights_(model, gen)
    model.eval()
    bb = cfg.backbone
    pcfg = PipelineConfig(
        seq_len=64 if tiny else model_cfg.max_inp_length,
        query_num=bb.query_num, patch_size=bb.vit.patch_size,
        src_grid=bb.vit.pos_grid,
        scale_resolution=8 if tiny else bb.scale_resolution,
        max_patches=64 if tiny else 1152)
    return model, pcfg
