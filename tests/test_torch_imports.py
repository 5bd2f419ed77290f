"""visrag_tpu_torch imports and runs without JAX, Flax or visrag_tpu."""

import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

_PROGRAM = r"""
import sys
before = set(sys.modules)
import numpy as np
import torch
from PIL import Image
import visrag_tpu_torch.driver.eval_retriever
import visrag_tpu_torch.driver.evisrag_eval
import visrag_tpu_torch.driver.evisrag_predict
import visrag_tpu_torch.driver.rl_main
import visrag_tpu_torch.driver.sft_main
import visrag_tpu_torch.driver.train_retriever
from visrag_tpu_torch.driver.common import build_qwen25_vl
from visrag_tpu_torch.generation import prompts, qa_eval
from visrag_tpu_torch.models.qwen25_vl import Qwen25VLConfig
from visrag_tpu_torch.ops import (attention, attention_kvgrid, matmul_int8,
                                  norms, quant)
from visrag_tpu_torch.rl import (advantage, critic, metrics, packing, ppo,
                                 reward_manager, rewards, seqlen)
from visrag_tpu_torch.rl.trainer import RLTrainer
from visrag_tpu_torch.serving import kv_cache, paged_kv, sampling
from visrag_tpu_torch.serving.engine import Engine
from visrag_tpu_torch.config import ModelConfig
from visrag_tpu_torch.preprocess import MockTokenizer, build_encode_batch
from visrag_tpu_torch.driver.common import build_visrag_ret
from visrag_tpu_torch.preprocess.device import (finish_encode_batch,
                                                pos_table_tensor)
from visrag_tpu_torch.retrieval.search import topk_single
from visrag_tpu_torch.training import (checkpoint, contrastive, lora, optim,
                                       sft, trainer)

model, pcfg = build_visrag_ret(ModelConfig(), tiny=True, device="cpu")
rng = np.random.default_rng(0)
items = [("", Image.fromarray(rng.integers(0, 255, (40, 30, 3),
                                           dtype=np.uint8))),
         ("a text query", None)]
raw = build_encode_batch(MockTokenizer(), items, pcfg, device_mode=True)
with torch.inference_mode():
    reps = model(finish_encode_batch(raw, pos_table_tensor(pcfg.src_grid,
                                                           "cpu")))
assert reps.shape == (2, 64) and torch.isfinite(reps).all()
topk_single(reps, reps, 2)
# the int8 encode (quant="int8" in the ViT and the LM) on the same weights
import dataclasses
from visrag_tpu_torch.models.visrag_ret import VisRAGRet
bb = model.cfg.backbone
q8 = VisRAGRet(dataclasses.replace(model.cfg, backbone=dataclasses.replace(
    bb, vit=dataclasses.replace(bb.vit, quant="int8", remat=False),
    llm=dataclasses.replace(bb.llm, quant="int8", remat=False))))
q8.load_state_dict(model.state_dict())
with torch.inference_mode():
    reps8 = q8.eval()(finish_encode_batch(raw, pos_table_tensor(pcfg.src_grid,
                                                                "cpu")))
assert torch.isfinite(reps8).all() and (reps8 * reps).sum(1).min() > 0.9
qwen = build_qwen25_vl(Qwen25VLConfig.tiny(), device="cpu")
for cache_dtype in ("bfloat16", "int8"):
    outs = Engine(qwen, num_slots=2, max_len=64, prompt_buckets=(16,),
                  cache_dtype=cache_dtype).generate(
        [dict(input_ids=np.arange(5, dtype=np.int32))],
        sampling=sampling.SamplingParams(temperature=0.0, max_tokens=3))
    assert len(outs[0]) == 3
# one RL step through the driver's own wiring: rollout, rewards, log-probs,
# the packed update, a checkpoint
import tempfile
from visrag_tpu_torch.config import RLConfig
cfg = RLConfig()
cfg = dataclasses.replace(
    cfg, rollout=dataclasses.replace(cfg.rollout, n=2, max_response_length=4),
    trainer=dataclasses.replace(cfg.trainer, total_steps=1, save_freq=1,
                                rollout_batch_size=2,
                                output_dir=tempfile.mkdtemp()))
rl = RLTrainer(qwen, cfg, tokenizer_decode=lambda ids: "wrong" if sum(ids) % 2
               else "<answer>x</answer>",
               tag_token_ids={"<think>": [50], "<evidence>": [51],
                              "<answer>": [52]},
               engine_kwargs=dict(num_slots=2, max_len=64,
                                  prompt_buckets=(16,)))
hist = rl.fit([[dict(input_ids=np.arange(3, 9, dtype=np.int32),
                     ground_truth="<answer>x</answer>"),
                dict(input_ids=np.arange(7, dtype=np.int32),
                     ground_truth="<answer>x</answer>")]])
assert len(hist) == 1 and np.isfinite(hist[0][1]["loss"])
# one GAE step (the critic from the driver's build_critic) and one SFT step
from visrag_tpu_torch.driver.rl_main import build_critic
from visrag_tpu_torch.driver.sft_main import build_sft, make_sft_batch
gae = dataclasses.replace(cfg, algorithm=dataclasses.replace(
    cfg.algorithm, adv_estimator="gae"), trainer=dataclasses.replace(
    cfg.trainer, output_dir=tempfile.mkdtemp()))
rl = RLTrainer(qwen, gae, tokenizer_decode=lambda ids: "wrong",
               tag_token_ids={"<think>": [50], "<evidence>": [51],
                              "<answer>": [52]},
               engine_kwargs=dict(num_slots=2, max_len=64,
                                  prompt_buckets=(16,)),
               critic=build_critic(qwen, gae))
hist = rl.fit([[dict(input_ids=np.arange(3, 9, dtype=np.int32),
                     ground_truth="<answer>x</answer>")] * 2])
assert np.isfinite(hist[0][1]["critic/vf_loss"])
_, step = build_sft(qwen, sft.SFTConfig(lr=1e-4))
m = step(make_sft_batch([(np.arange(2, 12, dtype=np.int32),
                          np.r_[np.zeros(5), np.ones(5)].astype(np.int32))]))
assert np.isfinite(float(m["loss"]))
# VisRAG-Gen: the three backends' builders on tiny random weights, the
# generation layer, the beam search and the demo's modules
import visrag_tpu_torch.driver.demo
from visrag_tpu_torch.driver import generate_eval as ge
from visrag_tpu_torch.generation import gen_eval, strategies
from visrag_tpu_torch.preprocess import rasterize
from visrag_tpu_torch.serving import beam
page = items[0][1]
for backend in ("minicpmv", "minicpmv26", "minicpm"):
    gm = ge.random_generation_model(backend, tiny=True, device="cpu")
    fn = ge.build_backend(backend, gm, MockTokenizer(), max_new_tokens=3,
                          tiny=True)
    task = {"minicpmv": "weighted_selection", "minicpmv26": "multi_image",
            "minicpm": "text"}[backend]
    out = strategies.generate_with_strategy(
        task, "what?", [page, page], [1.0, 0.5], fn,
        lambda q, n: gen_eval.build_image_prompt("InfoVQA", q),
        score_fn=getattr(fn, "score_fn", None))
    assert isinstance(out, str)
# the SigLIP baseline, the int8 scan, self_retrieve and the single-GPU
# remainder (gelu, hf_export, ocr, utils, the synthesize twin)
import visrag_tpu_torch.driver.synthesize_queries
from visrag_tpu_torch.models import hf_export
from visrag_tpu_torch.models.hf_loader import load_siglip_hf_state
from visrag_tpu_torch.models.siglip import SiglipConfig, SiglipModel
from visrag_tpu_torch.ops.gelu import fast_gelu
from visrag_tpu_torch.preprocess import ocr
from visrag_tpu_torch.retrieval.search import (StreamingSearcher,
                                               self_retrieve)
from visrag_tpu_torch.utils import profiling, timing
sig = SiglipModel(SiglipConfig.tiny()).eval()
load_siglip_hf_state(sig, sig.state_dict())
with torch.inference_mode():
    t, v = sig(torch.zeros(2, 16, dtype=torch.long), torch.zeros(2, 16, 48))
reps = torch.nn.functional.normalize(torch.cat([t, v]), dim=-1).numpy()
s8, i8 = StreamingSearcher(2, device="cpu", quant="int8").search(
    reps, [(reps, 0)])
assert np.isfinite(s8).all() and i8.shape == (4, 2)
assert len(self_retrieve(reps, list("abcd"), 2, device="cpu")) == 4
assert fast_gelu(torch.ones(3, dtype=torch.bfloat16)).dtype == torch.bfloat16
assert ocr.merge_adjacent([(0, 0, 5, 5, "a"), (6, 0, 9, 5, "b")]) == ["a b"]
assert set(hf_export.export_visrag_ret(model)) >= {"llm.model.norm.weight"}
assert timing.measure(lambda: None, iters=2) >= 0
with profiling.span("x"):
    pass
# the multi-device layer: a one-rank gloo mesh, the sharded search and
# the sequence-parallel attention at seq 1, Ulysses' and ring's modules
import torch.distributed as dist
from visrag_tpu_torch import mesh as vmesh
from visrag_tpu_torch.parallel import ring, ulysses
from visrag_tpu_torch.retrieval.search import make_sharded_topk
one = vmesh.single_device_mesh("cpu")
s1, i1 = make_sharded_topk(one, 2)(torch.from_numpy(reps),
                                   torch.from_numpy(reps), 4)
assert torch.equal(i1, topk_single(torch.from_numpy(reps),
                                   torch.from_numpy(reps), 2)[1])
x = torch.randn(1, 8, 2, 16)
assert ulysses.sp_flash_attention(x, x, x, causal=True, mesh=one).shape == \
    x.shape
dist.destroy_process_group()
added = sorted(m for m in set(sys.modules) - before
               if m.split(".")[0] in ("jax", "jaxlib", "flax", "visrag_tpu"))
print("ADDED", added)
"""

# an import of jax, flax or visrag_tpu (not visrag_tpu_torch)
_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|flax|visrag_tpu(?!_torch))\b", re.M)


def test_port_runs_without_jax():
    """Importing the drivers, the training, serving, RL, int8 and norm
    modules, encoding a batch (bf16 and int8), generating with the serving
    engine (bf16 and int8 pools), taking one RLTrainer.fit step, one GAE
    step with the critic and one SFT step, and answering through the three
    VisRAG-Gen backends (beam-scored weighted selection on MiniCPM-V 2.0,
    two pages on 2.6, text on MiniCPM-2B), and running the SigLIP bi-tower,
    the int8 scan, self_retrieve, fast_gelu, the exporters, OCR, the utils
    and the synthesize twin's module, and the multi-device layer (mesh,
    parallel/ulysses and parallel/ring, the sharded top-k on a one-rank
    gloo mesh) load no module of jax, flax or visrag_tpu."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _PROGRAM], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "ADDED []" in proc.stdout, proc.stdout


def test_no_jax_import_in_port_sources():
    offenders = [str(p) for p in (ROOT / "visrag_tpu_torch").rglob("*.py")
                 if _FORBIDDEN.search(p.read_text())]
    assert not offenders, offenders


def test_forbidden_pattern():
    for line in ("import jax", "from jax import numpy", "import flax.linen",
                 "from visrag_tpu.config import X", "import visrag_tpu",
                 "    from visrag_tpu.models import y"):
        assert _FORBIDDEN.search(line), line
    for line in ("from visrag_tpu_torch.config import X",
                 "import visrag_tpu_torch", "# from visrag_tpu import x",
                 "import jaxlike"):
        assert not _FORBIDDEN.search(line), line


def test_chip_smoke_imports_only_the_port():
    assert not _FORBIDDEN.search((ROOT / "chip_smoke.py").read_text())
