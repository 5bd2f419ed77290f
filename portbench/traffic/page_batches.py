"""Traffic kind `page_batches`: a corpus being indexed. Batches of page
images go one after another through the retriever's encode step as the
port's eval_retriever applies it (device finish → ViT → resampler → LM →
wmean → L2), each batch ending with its embeddings on the host.

Mix parameters: `batch_size`; `page_sizes` ([w, h], each batch holding
batch_size / len(page_sizes) pages of every size, in an order drawn from
the seed); `distinct_batches` (built in set-up by the program's host
pipeline, then cycled through by the window); `warmup_batches`;
`profiled_batches` (the profiled part of a traced window);
`check_batches` (how many of the window's distinct batches the reference
judges, drawn from the seed); `p_max_len` (eval_retriever's token cap
for pages). A `tiny` block overrides them for the CPU tests.

Compared: `weights_changed` (1 if the program altered the benchmark's
weights, limit 0) and `emb_err`, the largest L2 distance between a
page's embedding and the float32 reference's (both unit vectors).

The control (`Run.control`): the program's own int8 path (w8a8 ViT and
LM, `quant="int8"`) on the same weights and judged batches.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from PIL import Image

from portbench import counts, models, weights
from portbench.reference import visrag_ret as reference


def calibration_mix(mix: dict) -> dict:
    """The mix with one distinct batch (calibration's short set-up)."""
    return dict(mix, distinct_batches=1)


def page_images(rng, sizes, n: int):
    """n uint8 noise pages, the sizes cycled in an order drawn from rng."""
    order = rng.permutation(np.resize(np.arange(len(sizes)), n))
    return [Image.fromarray(rng.integers(0, 256, (sizes[i][1], sizes[i][0], 3),
                                         dtype=np.uint8)) for i in order]


class Run:
    def __init__(self, cell, seed, device, tiny):
        from visrag_tpu_torch.preprocess import (MockTokenizer,
                                                 build_encode_batch,
                                                 pick_patch_bucket)
        from visrag_tpu_torch.preprocess.device import (finish_encode_batch,
                                                        pos_table_tensor)
        mix = dict(cell.mix, **(cell.mix.get("tiny", {}) if tiny else {}))
        self.mix, self.device, self.seed, self.tiny = mix, device, seed, tiny
        self.model, self.ref_cfg, pcfg = models.retriever(cell.config, seed,
                                                          device, tiny)
        self.config = cell.config
        self.tok = MockTokenizer()
        table = pos_table_tensor(pcfg.src_grid, device)
        self.table = table

        @torch.inference_mode()
        def apply(**raw):
            return self.model(finish_encode_batch(raw, table))
        self.apply = apply
        rng = np.random.default_rng(seed)
        bucket_kw = {"buckets": tuple(mix["patch_buckets"])} \
            if "patch_buckets" in mix else {}
        self.batches = []
        for _ in range(mix["distinct_batches"]):
            pages = page_images(rng, mix["page_sizes"], mix["batch_size"])
            items = [("", im) for im in pages]
            # the batch as eval_retriever builds it
            bcfg = dataclasses.replace(
                pcfg, seq_len=min(mix["p_max_len"], pcfg.seq_len),
                max_patches=min(pcfg.max_patches,
                                pick_patch_bucket(items, pcfg, **bucket_kw)))
            raw = build_encode_batch(
                self.tok, items, bcfg,
                n_slice_slots=len(items) * pcfg.max_slices_per_page,
                device_mode=True)
            slices = [int(n) for n in raw["patch_mask"].sum(1) if n]
            tokens = [int(n) for n in raw["attention_mask"].sum(1)]
            self.batches.append({
                "raw": raw, "pages": pages, "slices": slices,
                "tokens": tokens, "ids": [raw["input_ids"][i, :n].tolist()
                                          for i, n in enumerate(tokens)],
                "flops": sum(counts.visrag_ret_flops(
                    self.ref_cfg, slices, tokens).values())})
        self.outputs = {}
        self.done = []
        self.fingerprint = weights.fingerprint(self.model)

    def warmup(self):
        # every batch has the same shapes (the same page sizes, slice slots
        # and token rows): a few batches build everything the window runs
        for b in self.batches[:self.mix["warmup_batches"]]:
            self.apply(**b["raw"]).float().cpu()

    def instrument(self, tracer):
        bb = self.model.backbone
        tracer.hook(bb.vpm, "vision", end_module=bb.resampler)
        tracer.hook(bb.llm, "lm")

    def window(self, seconds, tracer):
        from visrag_tpu_torch.retrieval.encode import make_encode_step
        step = make_encode_step(self.apply)
        nb = len(self.batches)
        profiled = self.mix["profiled_batches"] if tracer.on else 0

        def one(i):
            b = i % nb
            with tracer.span("batch"):
                reps = step(**self.batches[b]["raw"])
                with tracer.span("to_host"):
                    self.outputs[b] = reps.float().cpu().numpy()
            self.done.append(b)

        i = 0
        t0 = time.perf_counter()
        with tracer.profile():
            while i < profiled:
                one(i)
                i += 1
        tracer.profiled["batches"] = list(range(profiled))
        while time.perf_counter() - t0 < seconds:
            one(i)
            i += 1
        elapsed = time.perf_counter() - t0
        pages = i * self.mix["batch_size"]
        return {"metrics": {"embed_pages_per_s": pages / elapsed},
                "attempted": pages, "failed": 0, "elapsed": elapsed,
                "flops": sum(self.batches[b]["flops"] for b in self.done)}

    def release(self):
        self.apply = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def judged(self):
        """The distinct batches the reference judges, drawn from the seed
        among those the window encoded."""
        done = sorted(self.outputs)
        rng = np.random.default_rng([self.seed, 7])
        return list(rng.choice(done, size=min(self.mix["check_batches"],
                                              len(done)), replace=False))

    def check(self):
        changed = float(weights.fingerprint(self.model) != self.fingerprint)
        worst = 0.0
        special = {"im_start_id": self.tok.im_start_id,
                   "im_end_id": self.tok.im_end_id}
        for b in self.judged():
            batch = self.batches[b]
            ref = reference.embed(
                dict(self.model.named_parameters()), self.ref_cfg,
                list(zip(batch["pages"], batch["ids"])), special,
                self.device).cpu().numpy()
            got = self.outputs[b][:len(ref)]
            worst = max(worst, float(np.linalg.norm(got - ref, axis=1).max()))
        return [("weights_changed", changed), ("emb_err", worst)]

    def control(self):
        """The control's reading on the judged batches: the program's int8
        encoder on the benchmark's weights, judged as check() judges."""
        from visrag_tpu_torch.preprocess.device import finish_encode_batch
        model8 = models.retriever_int8(self.config, self.model, self.tiny)
        special = {"im_start_id": self.tok.im_start_id,
                   "im_end_id": self.tok.im_end_id}
        worst = 0.0
        for b in self.judged():
            batch = self.batches[b]
            with torch.inference_mode():
                got = model8(finish_encode_batch(batch["raw"],
                                                 self.table)).float()
            ref = reference.embed(
                dict(self.model.named_parameters()), self.ref_cfg,
                list(zip(batch["pages"], batch["ids"])), special,
                self.device)
            worst = max(worst, float((got[:len(ref)] - ref).norm(dim=1)
                                     .max()))
        return [("emb_err", worst)]
