"""Traffic kind `query_batches`: query latency over a resident corpus. One
client sends a batch of queries, waits for its top-k, and sends the next
(a closed loop). A batch goes from its token ids, through the retriever's
encode step (text only: one empty slice stands in for the vision part),
wmean and L2, and the exact top-k scan over the corpus, to the ids and
scores on the host.

Mix parameters: `batch_size`; `query_chars` ([lo, hi]: each batch's
queries carry eval_retriever's query_template around lo .. hi characters,
spaced evenly, in an order drawn from the seed; the stand-in tokenizer
gives a token a character); `distinct_batches` (tokenised in set-up);
`corpus_rows` and `k` (the corpus: unit rows of the LM's width made on the
device from the seed, float32); `q_max_len` (eval_retriever's token cap
for queries); `warmup_batches`; `profiled_batches`; `check_batches`. A
`tiny` block overrides them for the CPU tests.

Compared: `weights_changed` (limit 0), `query_emb_err` (the largest L2
distance between a query's embedding and the float32 reference's from the
same token ids) and `scan_err` (the scan stage on the program's own query
embeddings: the largest gap between a returned top-k score, or the float64
score of a returned id, and the exact float64 top-k).

The control (`Run.control`): the reference computed in fp8 e4m3 (w8a8) in
the program's place for the query embeddings, and the program's int8
corpus scan (`topk_single_int8`) on the program's query embeddings.
"""

from __future__ import annotations

import dataclasses
import statistics
import string
import time

import numpy as np
import torch

from portbench import counts, harness, models, weights
from portbench.reference import scan as ref_scan
from portbench.reference import visrag_ret as reference

TEMPLATE = "Represent this query for retrieving relevant documents: <query>"


def calibration_mix(mix: dict) -> dict:
    """The mix with one distinct batch (calibration's short set-up)."""
    return dict(mix, distinct_batches=1)


def make_corpus(rows: int, dim: int, seed: int, device,
                block: int = 1 << 17) -> torch.Tensor:
    """Unit float32 rows drawn on the device, block by block."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    corpus = torch.empty(rows, dim, dtype=torch.float32, device=device)
    for lo in range(0, rows, block):
        part = corpus[lo:lo + block]
        part.normal_(generator=gen)
        part.div_(part.norm(dim=1, keepdim=True))
    return corpus


def query_texts(rng, n: int, lo: int, hi: int):
    """n queries of lo .. hi characters (evenly spaced lengths, shuffled)."""
    letters = np.array(list(string.ascii_lowercase + " "))
    lengths = rng.permutation(np.linspace(lo, hi, n).round().astype(int))
    return [TEMPLATE.replace("<query>", "".join(rng.choice(letters, size=m)))
            for m in lengths]


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
        self.tok = MockTokenizer()
        table = pos_table_tensor(pcfg.src_grid, device)

        @torch.inference_mode()
        def apply(**raw):
            return self.model(finish_encode_batch(raw, table))
        self.apply = apply
        rng = np.random.default_rng(seed)
        self.batches = []
        for _ in range(mix["distinct_batches"]):
            items = [(t, None) for t in query_texts(
                rng, mix["batch_size"], *mix["query_chars"])]
            # as eval_retriever builds a query batch, with one empty slice
            # (eval_retriever gives it batch_size x 10)
            qcfg = dataclasses.replace(
                pcfg, seq_len=min(mix["q_max_len"], pcfg.seq_len),
                max_patches=min(pcfg.max_patches,
                                pick_patch_bucket(items, pcfg)))
            raw = build_encode_batch(self.tok, items, qcfg, device_mode=True)
            tokens = [int(n) for n in raw["attention_mask"].sum(1)]
            self.batches.append({
                "raw": raw, "tokens": tokens,
                "ids": [raw["input_ids"][i, :n].tolist()
                        for i, n in enumerate(tokens)],
                "flops": counts.minicpm_flops(self.ref_cfg["llm"], tokens)
                + counts.scan_counts(mix["corpus_rows"],
                                     self.ref_cfg["llm"]["hidden_size"],
                                     len(tokens), mix["k"])[0]})
        self.corpus = make_corpus(mix["corpus_rows"],
                                  self.ref_cfg["llm"]["hidden_size"],
                                  seed + 1, device)
        self.outputs = {}
        self.fingerprint = weights.fingerprint(self.model)

    def search(self, b, tracer=None):
        from visrag_tpu_torch.retrieval.search import topk_single
        raw = self.batches[b]["raw"]
        with harness.maybe_span(tracer, "encode"):
            reps = self.apply(**raw)
        with harness.maybe_span(tracer, "scan"):
            scores, ids = topk_single(reps, self.corpus, self.mix["k"])
        with harness.maybe_span(tracer, "to_host"):
            return reps.float().cpu(), scores.cpu(), ids.cpu()

    def warmup(self):
        # every batch has the same shapes (64 rows of q_max_len tokens)
        for i in range(self.mix["warmup_batches"]):
            self.search(i % len(self.batches))

    def instrument(self, tracer):
        tracer.hook(self.model.backbone.llm, "lm")

    def window(self, seconds, tracer):
        nb = len(self.batches)
        profiled = self.mix["profiled_batches"] if tracer.on else 0
        latencies = []

        def one(i):
            b = i % nb
            t = time.perf_counter()
            with tracer.span("batch"):
                self.outputs[b] = self.search(b, tracer)
            latencies.extend([time.perf_counter() - t]
                             * self.mix["batch_size"])

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
        return {"metrics": {"search_p95_ms":
                            statistics.quantiles(latencies, n=100,
                                                 method="inclusive")[94]
                            * 1e3},
                "attempted": len(latencies), "failed": 0, "elapsed": elapsed,
                "flops": sum(self.batches[j % nb]["flops"]
                             for j in range(i))}

    def release(self):
        self.apply = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def judged(self):
        done = sorted(self.outputs)
        rng = np.random.default_rng([self.seed, 7])
        return list(rng.choice(done, size=min(self.mix["check_batches"],
                                              len(done)), replace=False))

    def check(self):
        changed = float(weights.fingerprint(self.model) != self.fingerprint)
        emb = scan = 0.0
        params = dict(self.model.named_parameters())
        for b in self.judged():
            batch = self.batches[b]
            reps, scores, ids = self.outputs[b]
            ref = reference.embed(params, self.ref_cfg,
                                  [(None, x) for x in batch["ids"]], {},
                                  self.device).cpu()
            emb = max(emb, float((reps - ref).norm(dim=1).max()))
            scan = max(scan, scan_gap(reps, scores, ids, self.corpus,
                                      self.mix["k"]))
        return [("weights_changed", changed), ("query_emb_err", emb),
                ("scan_err", scan)]

    def control(self, low: str = "fp8"):
        """The control's readings on the judged batches: the reference in
        `low` (w8a8) in the program's place for the query embeddings, the
        program's int8 corpus for the scan."""
        from visrag_tpu_torch.retrieval.search import (quantize_rows,
                                                       topk_single_int8)
        params = dict(self.model.named_parameters())
        emb = scan = 0.0
        for b in self.judged():
            items = [(None, x) for x in self.batches[b]["ids"]]
            ref = reference.embed(params, self.ref_cfg, items, {},
                                  self.device)
            got = reference.embed(params, self.ref_cfg, items, {},
                                  self.device, low=low)
            emb = max(emb, float((got - ref).norm(dim=1).max()))
            qs = self.outputs[b][0].to(self.device)
            cq, cs = quantize_rows(self.corpus)
            scores, ids = topk_single_int8(qs, cq, cs, self.mix["k"])
            del cq, cs
            scan = max(scan, scan_gap(qs.cpu(), scores.cpu(), ids.cpu(),
                                      self.corpus, self.mix["k"]))
        return [("query_emb_err", emb), ("scan_err", scan)]


def scan_gap(queries, scores, ids, corpus, k) -> float:
    """The largest gap between the returned top-k (its scores, and the
    float64 scores of its ids) and the exact float64 top-k."""
    best, _ = ref_scan.topk64(queries, corpus, k)
    got = torch.sort(scores.double().to(best.device), dim=1,
                     descending=True).values
    of_ids = torch.sort(ref_scan.scores_of(queries, corpus, ids), dim=1,
                        descending=True).values
    return float(torch.maximum((got - best).abs(),
                               (of_ids - best).abs()).max())
