"""The port's single-GPU remainder against the JAX package, on the CPU:
ops/gelu.py, utils/{timing,profiling}.py, preprocess/ocr.py,
models/hf_export.py and driver/synthesize_queries.py.

  * fast_gelu on all 65,536 bf16 patterns: the JAX fast_gelu's output on
    the normal range (XLA on the CPU flushes subnormals, as the JAX test
    says) and float64 erfc-GELU on every finite input; F.gelu in bf16
    differs from the JAX function, so the port's SigLIP ViT (act="erf")
    runs fast_gelu; its gradient is the exact gelu';
  * timing and profiling.trace on the CPU (the spans and counters are
    tests/test_torch_tracing.py's);
  * the OCR line merging equals the JAX copy's on the same detections;
  * each exporter's state loads back through the port's own loader bit for
    bit, and its names and values are the JAX exporter's on the JAX tree
    of the same weights, but for the LM's `llm.model.*` names (ROADMAP §3);
  * the synthesize twin's request (ids, mrope positions, slot map) is the
    JAX tool's for one page and a stand-in processor, its generator runs a
    tiny Qwen2.5-VL, and its JSONL records are the tool's.
"""

import importlib.util
import io
import json
import math
import os
import pathlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

import jax.numpy as jnp

from visrag_tpu.ops.gelu import fast_gelu as jfast_gelu
from visrag_tpu_torch.ops import gelu
from visrag_tpu_torch.utils import profiling, timing

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- GELU ------------------------------------------------------------------


def _bf16_sweep():
    u16 = np.arange(65536, dtype=np.uint32)
    return (u16 << 16).view(np.float32)


def _neq(a, b):
    """Bitwise inequality of float arrays, NaNs equal."""
    return ~(np.isnan(a) & np.isnan(b)) & (a.view(np.uint32)
                                           != b.view(np.uint32))


def test_fast_gelu_bf16_exhaustive():
    from scipy.special import erfc
    f32 = _bf16_sweep()
    x = torch.from_numpy(f32.copy()).bfloat16()
    out = gelu.fast_gelu(x).float().numpy()
    jout = np.asarray(jfast_gelu(jnp.asarray(f32).astype(jnp.bfloat16))
                      .astype(jnp.float32))
    with np.errstate(invalid="ignore", over="ignore"):
        x64 = f32.astype(np.float64)
        ref = 0.5 * x64 * erfc(-x64 / math.sqrt(2))
    finite = np.isfinite(f32)
    refb = torch.from_numpy(np.where(finite, ref, 0).astype(np.float32)) \
        .bfloat16().float().numpy()
    assert not _neq(out, refb)[finite].any()
    normal = finite & (np.abs(f32) >= 2.0 ** -126) \
        & (np.abs(ref) >= 2.0 ** -126)
    assert not _neq(out, jout)[normal].any()
    assert not _neq(out, jout)[~finite].any()      # inf → inf, -inf → -0
    lib = F.gelu(x).float().numpy()
    assert _neq(lib, jout)[normal].sum() > 0
    from visrag_tpu_torch.models.siglip_vit import Mlp, SiglipViTConfig
    assert Mlp(SiglipViTConfig.tiny()).act is gelu.fast_gelu


def test_fast_gelu_fp32_and_gradient():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.concatenate(
        [rng.normal(scale=s, size=4000) for s in (0.5, 2.0, 8.0)]))
    x64 = x.clone().requires_grad_(True)
    want = F.gelu(x64)
    want_grad, = torch.autograd.grad(want.sum(), x64)
    got = gelu.fast_gelu(x.float())
    np.testing.assert_allclose(got.double().numpy(), want.detach().numpy(),
                               rtol=2e-6, atol=1e-7)
    xf = x.float().requires_grad_(True)
    got_grad, = torch.autograd.grad(gelu.fast_gelu(xf).sum(), xf)
    np.testing.assert_allclose(got_grad.double().numpy(), want_grad.numpy(),
                               rtol=1e-5, atol=1e-6)
    # bf16: F.gelu's own backward, bit for bit
    xb = x.bfloat16().requires_grad_(True)
    xl = x.bfloat16().requires_grad_(True)
    g = torch.from_numpy(rng.normal(size=x.shape)).bfloat16()
    gb, = torch.autograd.grad(gelu.fast_gelu(xb), xb, g)
    gl, = torch.autograd.grad(F.gelu(xl), xl, g)
    assert torch.equal(gb, gl)


# ---- utils -----------------------------------------------------------------


def test_timing_and_profiling_on_cpu(tmp_path):
    calls = []

    def fn(a):
        calls.append(1)
        return a @ a

    t = timing.measure(fn, torch.ones(8, 8), iters=5, warmup=2)
    assert t > 0 and len(calls) == 7
    with profiling.trace(str(tmp_path / "p")) as prof:
        fn(torch.ones(16, 16))
    names = {e.get("name") for e in json.loads(
        (tmp_path / "p" / profiling.TRACE_FILE).read_text())["traceEvents"]}
    assert "aten::mm" in names
    assert any(e.key == "aten::mm" for e in prof.key_averages())


# ---- OCR -------------------------------------------------------------------


def test_ocr_merging_matches_jax():
    from visrag_tpu.preprocess import ocr as jocr
    from visrag_tpu_torch.preprocess import ocr
    rng = np.random.default_rng(1)
    dets = []
    for line in range(6):
        y = 20.0 * line + rng.uniform(-3, 3)
        for word in range(int(rng.integers(1, 5))):
            x = 60.0 * word + rng.uniform(0, 20)
            dets.append((x, y, x + 40.0, y + 12.0 + rng.uniform(-2, 2),
                         f"w{line}_{word}"))
    rng.shuffle(dets)
    assert ocr.merge_adjacent(dets) == jocr.merge_adjacent(dets)
    assert ocr.layout_preserving_text(dets) == \
        jocr.layout_preserving_text(dets)
    img = Image.new("RGB", (8, 8))
    for layout in ("lines", "preserve"):
        assert ocr.page_to_text(img, lambda _: dets, layout) == \
            jocr.page_to_text(img, lambda _: dets, layout)
    if importlib.util.find_spec("pytesseract") is None:
        with pytest.raises(ImportError, match="pytesseract"):
            ocr.tesseract_backend(img)


# ---- HF export -------------------------------------------------------------


def _random(model, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    return model


def _np(state):
    return {k: v.numpy() for k, v in state.items()}


def _equal_modules(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def _equal_states(port, jax_state):
    assert port.keys() == jax_state.keys()
    for k, v in port.items():
        np.testing.assert_array_equal(v.numpy(), jax_state[k], err_msg=k)


def test_export_visrag_ret_roundtrip_and_jax_names(tmp_path):
    from visrag_tpu.models import hf_export as jexport
    from visrag_tpu.models.hf_loader import convert_visrag_ret
    from visrag_tpu_torch.models import hf_export, hf_loader
    from visrag_tpu_torch.models.minicpmv import MiniCPMVConfig
    from visrag_tpu_torch.models.siglip_vit import SiglipViTConfig
    from visrag_tpu_torch.models.visrag_ret import VisRAGRet, VisRAGRetConfig
    cfg = VisRAGRetConfig(backbone=MiniCPMVConfig.tiny(
        vit=SiglipViTConfig.tiny(patch_size=14)))
    model = _random(VisRAGRet(cfg), 0)
    state = hf_export.export_visrag_ret(model)
    back = VisRAGRet(cfg)
    hf_loader.load_visrag_ret_state(back, hf_loader.minicpmv_hf_to_port(
        state, cfg.backbone.vit.depth))
    _equal_modules(model, back)
    path = hf_export.save_safetensors(state, str(tmp_path / "ret"))
    assert os.path.basename(path) == "model.safetensors"
    again = VisRAGRet(cfg)
    hf_loader.load_visrag_ret_state(again, hf_loader.minicpmv_hf_to_port(
        hf_loader.load_safetensors_dir(str(tmp_path / "ret")),
        cfg.backbone.vit.depth))
    _equal_modules(model, again)
    jstate = jexport.export_visrag_ret(convert_visrag_ret(
        _np(state), vit_depth=cfg.backbone.vit.depth))
    renamed = {}
    for k, v in jstate.items():
        if k.startswith("llm."):       # the JAX exporter's LM names
            k = "llm.model." + k[len("llm."):].replace(
                "embed_tokens.embedding", "embed_tokens.weight")
        renamed[k] = v
    _equal_states(state, renamed)


def test_export_qwen25_vl_roundtrip_and_jax_names():
    from visrag_tpu.models import hf_export as jexport
    from visrag_tpu.models.hf_loader import convert_qwen25_vl
    from visrag_tpu_torch.models import hf_export, hf_loader
    from visrag_tpu_torch.models.qwen25_vl import Qwen25VL, Qwen25VLConfig
    for cfg in (Qwen25VLConfig.tiny(), Qwen25VLConfig.tiny(
            text=Qwen25VLConfig.tiny().text.__class__.tiny(
                tie_word_embeddings=False))):
        model = _random(Qwen25VL(cfg), 1)
        state = hf_export.export_qwen25_vl(model)
        back = Qwen25VL(cfg)
        hf_loader.load_qwen25_vl_state(back, state)
        _equal_modules(model, back)
        _equal_states(state, jexport.export_qwen25_vl(
            convert_qwen25_vl(_np(state))))


def test_export_minicpmv26_and_siglip_vision_roundtrip_and_jax_names():
    from visrag_tpu.models import hf_export as jexport
    from visrag_tpu.models.hf_loader import (convert_minicpmv26,
                                             convert_siglip_vision_hf)
    from visrag_tpu_torch.models import hf_export, hf_loader
    from visrag_tpu_torch.models.minicpmv26 import (MiniCPMV26Config,
                                                    MiniCPMV26ForGeneration)
    cfg = MiniCPMV26Config.tiny()
    model = _random(MiniCPMV26ForGeneration(cfg), 2)
    state = hf_export.export_minicpmv26(model)
    back = MiniCPMV26ForGeneration(cfg)
    hf_loader.load_generation_hf_state(back, state)
    _equal_modules(model, back)
    _equal_states(state, jexport.export_minicpmv26(
        convert_minicpmv26(_np(state))))
    vision = hf_export.export_siglip_vision_hf(model.vpm, prefix="vpm.")
    assert set(vision) == {k for k in state if k.startswith("vpm.")}
    _equal_states(vision, jexport.export_siglip_vision_hf(
        convert_siglip_vision_hf(_np(vision), prefix="vpm."),
        prefix="vpm."))


# ---- synthesize_queries ----------------------------------------------------


class _Processor:
    """Chat template and tokenizer with the tiny Qwen config's special ids;
    other words hash into ids below 100."""

    SPECIAL = {"<|im_start|>": 116, "<|im_end|>": 117,
               "<|vision_end|>": 118, "<|vision_start|>": 119,
               "<|image_pad|>": 120}
    eos_token_id = 117

    def apply_chat_template(self, messages, tokenize=False,
                            add_generation_prompt=True):
        out = ""
        for m in messages:
            body = "".join("<|vision_start|><|image_pad|><|vision_end|>"
                           if c["type"] == "image" else c["text"]
                           for c in m["content"])
            out += f"<|im_start|>{m['role']}\n{body}<|im_end|>\n"
        return out + "<|im_start|>assistant\n"

    def encode(self, text):
        import re
        import zlib
        ids = []
        for part in re.split("(" + "|".join(map(re.escape, self.SPECIAL))
                             + ")", text):
            if part in self.SPECIAL:
                ids.append(self.SPECIAL[part])
            else:
                ids.extend(zlib.crc32(w.encode()) % 100 for w in part.split())
        return ids

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(i) for i in ids)


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_synthesize_queries", ROOT / "tools" / "synthesize_queries.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_synthesize_request_matches_jax_tool():
    from visrag_tpu.models.mrope import get_rope_index
    from visrag_tpu.preprocess.qwen_vision import prepare_vision_batch
    from visrag_tpu_torch.driver import synthesize_queries as sq
    from visrag_tpu_torch.models.qwen25_vl import Qwen25VLConfig
    tool = _jax_tool()
    assert sq.SYNTH_PROMPT == tool.SYNTH_PROMPT
    cfg = Qwen25VLConfig.tiny()
    proc = _Processor()
    rng = np.random.default_rng(2)
    # a page larger than max_pixels, so that the cap decides the grid
    img = Image.fromarray(rng.integers(0, 255, (1100, 1000, 3), np.uint8))
    req = sq.build_request(proc, proc, cfg, img)
    # the JAX tool's steps (tools/synthesize_queries.py, its generate())
    vb = prepare_vision_batch([img], head_dim=cfg.vision.head_dim)
    text = proc.apply_chat_template(
        [{"role": "user", "content": [{"type": "image"},
                                      {"type": "text",
                                       "text": tool.SYNTH_PROMPT}]}],
        tokenize=False, add_generation_prompt=True)
    mu = cfg.vision.spatial_merge_size ** 2
    count = sum(t * h * w // mu for (t, h, w) in vb.grid_thw)
    text = text.replace("<|image_pad|>", "<|image_pad|>" * count, 1)
    ids = np.asarray(proc.encode(text), np.int32)
    slot = np.full(ids.shape, -1, np.int32)
    slot[ids == cfg.image_token_id] = np.arange(vb.n_tokens)
    np.testing.assert_array_equal(req["input_ids"], ids)
    np.testing.assert_array_equal(
        req["positions"], get_rope_index(ids, vb.grid_thw, cfg.image_token_id))
    np.testing.assert_array_equal(req["slot_map"], slot)
    # the cap decides: 1,003,520 pixels / 28² = 1,280 tokens at most, where
    # assemble_request's own default (1,568,000) gives more
    from visrag_tpu_torch.driver.evisrag_predict import assemble_request
    wider = assemble_request(proc, proc, cfg, [img], sq.SYNTH_PROMPT)
    assert count <= 1280 < (wider["slot_map"] >= 0).sum()


def test_synthesize_generator_and_records():
    from visrag_tpu_torch.driver import synthesize_queries as sq
    from visrag_tpu_torch.driver.common import build_qwen25_vl
    from visrag_tpu_torch.models.qwen25_vl import Qwen25VLConfig
    model = build_qwen25_vl(Qwen25VLConfig.tiny(), device="cpu")
    proc = _Processor()
    generate = sq.make_local_generator(proc, proc, model, max_tokens=3)
    img = Image.fromarray(np.full((56, 84, 3), 200, np.uint8))
    assert len(generate(img).split()) <= 3
    engine = sq.build_engine(model, proc.eos_token_id)
    assert (engine.num_slots, engine.max_len) == (4, 8192)
    text = ('noise [{"question": "q1", "answer": "a1"}, {"question": "q2"},'
            ' {"question": "q3", "answer": "a3"}] tail')
    pairs = sq.parse_pairs(text)
    out = io.StringIO()
    assert sq.write_pairs(out, "p.png", pairs) == 2
    assert [json.loads(l) for l in out.getvalue().splitlines()] == [
        {"page": "p.png", "query": "q1", "answer": "a1"},
        {"page": "p.png", "query": "q3", "answer": "a3"}]
    assert sq.parse_pairs("no json here") is None
