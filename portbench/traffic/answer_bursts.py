"""Traffic kind `answer_bursts`: questions about retrieved pages, answered
by Qwen2.5-VL through the port's serving engine. A burst of questions,
each with its top pages, is sent at once; the next burst goes when every
answer of the last is in (a batch job, as EVisRAG's offline prediction
runs). The window holds whole bursts, at least one: another burst is sent
only where, at the last one's pace, it would end within `--seconds`.

Mix parameters: `burst` (questions a burst); `pool` (requests assembled in
set-up with evisrag_predict's assemble_request; burst b takes the b-th block of
`burst`, cycling); `pages` (a request's pages) with `page_pixels` [lo, hi]
and `page_aspect` [lo, hi] (each page's area and height / width, sides in
multiples of 28 so that the pixel budget keeps it as drawn); `max_tokens`
[lo, hi] (log-uniform); `shape_seed` (the sizes, output budgets and
order of one burst's requests are drawn from it alone, so every seed
serves the same sizes in the same order, and the time to a burst's first
tokens does not hang on which sizes the seed puts first; the run's seed
draws the pixels and the questions); `method` (the EVisRAG prompt); `question_words`; `max_pixels`;
`engine` (overrides of evisrag_predict's engine settings); `check_requests`
(how many answered requests the reference judges, the longest among them,
drawn from the seed); `profiled_bursts` and `profiled_decode_chunks` (the
profiled part of a traced window: the first burst's prefills and its
first decode chunks). A `tiny` block overrides them for
the CPU tests.

Compared: `weights_changed` (limit 0) and `answer_gap`: the widest gap by
which a served token's logit (after the request's logit bias and
repetition penalty) lies below the float32 reference's best at its
position, with the reference run over the prompt and the served tokens.

The control (`Run.control`): the reference computed in fp8 e4m3 (w8a8:
activations per row, weights per output channel) over the same prompts
and served tokens, the gap of the token it puts first at each position.
"""

from __future__ import annotations

import math
import statistics
import time

import numpy as np
import torch
from PIL import Image

from portbench import counts, harness, models, weights
from portbench.reference import qwen25_vl as reference
from portbench.standin import StandInTokenizer

WORDS = ("revenue quarter total growth figure table page report year "
         "compare margin income chart share cost profit region segment "
         "forecast").split()


def calibration_mix(mix: dict) -> dict:
    """The mix with a pool of one burst (calibration's short set-up)."""
    return dict(mix, pool=mix["burst"])


def burst_shapes(mix: dict):
    """One burst's requests: [(page sizes [(h, w)], max_tokens)], drawn
    from the mix's shape seed alone."""
    rng = np.random.default_rng(mix["shape_seed"])
    f = 28
    out = []
    for _ in range(mix["burst"]):
        sizes = []
        for _ in range(mix["pages"]):
            area = rng.uniform(*mix["page_pixels"])
            aspect = rng.uniform(*mix["page_aspect"])
            h = max(f, int(math.sqrt(area * aspect) / f) * f)
            w = max(f, int(math.sqrt(area / aspect) / f) * f)
            sizes.append((h, w))
        lo, hi = mix["max_tokens"]
        out.append((sizes, int(round(math.exp(rng.uniform(math.log(lo),
                                                          math.log(hi)))))))
    return out


class Run:
    def __init__(self, cell, seed, device, tiny):
        from visrag_tpu_torch.driver.evisrag_predict import (
            ENGINE_SETTINGS, assemble_request, sampling_params)
        from visrag_tpu_torch.generation.prompts import build_prompt
        from visrag_tpu_torch.serving.engine import Engine
        mix = dict(cell.mix, **(cell.mix.get("tiny", {}) if tiny else {}))
        self.mix, self.device, self.seed = mix, device, seed
        self.model, self.ref_cfg, ids, text_vocab = models.qwen(
            cell.config, seed, device, tiny)
        self.tok = StandInTokenizer(ids, text_vocab)
        cfg = self.model.cfg
        rng = np.random.default_rng(seed)
        shapes = burst_shapes(mix)
        self.pool = []
        for j in range(mix["pool"]):
            sizes, max_tokens = shapes[j % len(shapes)]
            images = [Image.fromarray(rng.integers(0, 256, (h, w, 3),
                                                   dtype=np.uint8))
                      for h, w in sizes]
            query = " ".join(rng.choice(WORDS, size=mix["question_words"]))
            req = assemble_request(self.tok, self.tok, cfg, images,
                                   build_prompt(mix["method"], query),
                                   mix["max_pixels"])
            sp = sampling_params(self.tok, self.tok, 0.0, max_tokens)
            self.pool.append({"req": req, "images": images, "sampling": sp,
                              "sizes": sizes,
                              "flops": self.prefill_flops(req, sizes)})
        settings = dict(ENGINE_SETTINGS, **mix["engine"])
        settings["prompt_buckets"] = tuple(settings["prompt_buckets"])
        self.engine = Engine(self.model, eos_token_ids=[ids["eos_token_id"]],
                             cache_dtype="bfloat16", **settings)
        self.served = []          # (pool index, Request) of the window
        self.rid_pool = {}        # request id → pool index
        self.chunk = self.engine.chunk
        self.fingerprint = weights.fingerprint(self.model)

    # ---- model FLOPs --------------------------------------------------

    def windows(self, h: int, w: int):
        """Patch counts of the vision tower's windows over an h × w page,
        and its patch count."""
        v = self.ref_cfg["vision_config"]
        p = v["patch_size"]
        side = v["window_size"] // p
        gh, gw = h // p, w // p
        sizes = [min(side, gh - r) * min(side, gw - c)
                 for r in range(0, gh, side) for c in range(0, gw, side)]
        return sizes, gh * gw

    def prefill_flops(self, req, sizes) -> float:
        v = self.ref_cfg["vision_config"]
        win, imgs = [], []
        for h, w in sizes:
            ws, n = self.windows(h, w)
            win += ws
            imgs.append(n)
        out_hidden = v["out_hidden_size"]
        tower = counts.qwen_tower_flops(v, out_hidden, win, imgs) \
            if imgs else 0.0
        text = counts.qwen_text_flops(self.ref_cfg, [len(req["input_ids"])])
        return tower + text

    def decode_flops(self, prompt: int, n_out: int) -> float:
        if n_out <= 1:
            return 0.0
        return counts.qwen_text_flops(
            self.ref_cfg, [1] * (n_out - 1),
            past=[prompt + j for j in range(n_out - 1)])

    # ---- the run --------------------------------------------------------

    def burst(self, b: int, tracer=None):
        """Serve burst b → [(pool index, Request)]."""
        n = self.mix["burst"]
        idx = [(b * n + j) % len(self.pool) for j in range(n)]
        queued = []
        for i in idx:
            p = self.pool[i]
            rid = self.engine.add_request(sampling=p["sampling"],
                                          **p["req"])
            self.rid_pool[rid] = i
            queued.append((i, self.engine.queue[-1]))
        with harness.maybe_span(tracer, "burst"):
            self.engine.run()
        return queued

    def warmup(self):
        """The pool's shortest and longest prompts, one decode chunk each:
        the vision tower, whole and chunked prefill, decode, sampling."""
        from dataclasses import replace
        lens = [len(p["req"]["input_ids"]) for p in self.pool]
        for i in {int(np.argmin(lens)), int(np.argmax(lens))}:
            p = self.pool[i]
            self.engine.add_request(
                sampling=replace(p["sampling"],
                                 max_tokens=self.engine.chunk + 1),
                **p["req"])
        self.engine.run()

    def instrument(self, tracer):
        if not tracer.on:
            return
        e = self.engine
        prefill = ("_start_chunked", "_advance_chunk", "_prefill_one",
                   "_prefill_many")
        for name in prefill:
            tracer.sync_wrap(e, name, "prefill")

        profiled_chunks = []

        def before_decode(*a):
            # the profiled part ends after its first decode chunks: the
            # prefills and the start of decoding, in the trace's bounds
            if tracer.profiling and len(profiled_chunks) >= \
                    self.mix["profiled_decode_chunks"]:
                tracer.stop_profile()
            if tracer.profiling:
                profiled_chunks.append(1)
            state = (e.lengths.copy(), e.active.copy(), e.gen_left.copy())
            tracer.count("decode", (tracer.profiling, state))

        tracer.sync_wrap(e, "_decode_chunk", "decode", before=before_decode)

        def vision_run(req, *a):
            if req.vision_batch is not None:
                tracer.count("vision", (tracer.profiling,
                                        self.rid_pool[req.request_id]))
        for name in ("_start_chunked", "_prefill_one"):
            inner = getattr(e, name)

            def wrapped(req, *a, _inner=inner, **kw):
                vision_run(req)
                return _inner(req, *a, **kw)
            setattr(e, name, wrapped)

        def many(reqs, *a, _inner=e._prefill_many, **kw):
            for r in reqs:
                vision_run(r)
            return _inner(reqs, *a, **kw)
        e._prefill_many = many

    def window(self, seconds, tracer):
        profiled = self.mix["profiled_bursts"] if tracer.on else 0
        b = 0
        t0 = time.perf_counter()
        last = 0.0
        with tracer.profile():
            while b < profiled:
                t = time.perf_counter()
                self.served += self.burst(b, tracer)
                last = time.perf_counter() - t
                b += 1
        # whole bursts; another only where it would end inside the window
        while b == 0 or time.perf_counter() - t0 + last <= seconds:
            t = time.perf_counter()
            self.served += self.burst(b, tracer)
            last = time.perf_counter() - t
            b += 1
        elapsed = time.perf_counter() - t0
        ttft = [r.t_first - r.t_enqueue for _, r in self.served
                if r.t_first is not None]
        tokens = sum(len(r.output_ids) for _, r in self.served)
        failed = sum(1 for _, r in self.served
                     if not r.done or not r.output_ids)
        flops = sum(self.pool[i]["flops"]
                    + self.decode_flops(len(r.input_ids), len(r.output_ids))
                    for i, r in self.served)
        return {"metrics": {"answer_tokens_per_s": tokens / elapsed,
                            "ttft_p50_ms": statistics.median(ttft) * 1e3},
                "attempted": len(self.served), "failed": failed,
                "elapsed": elapsed, "flops": flops, "bursts": b}

    def release(self):
        self.engine.sleep()
        self.engine = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def judged(self):
        """Distinct answered requests drawn from the seed, with the
        longest (prompt and answer) among them."""
        by_pool = {}
        for i, r in self.served:
            if r.done and r.output_ids:
                by_pool[i] = r
        keys = sorted(by_pool)
        longest = max(keys, key=lambda i: len(by_pool[i].input_ids)
                      + len(by_pool[i].output_ids))
        rest = [k for k in keys if k != longest]
        rng = np.random.default_rng([self.seed, 7])
        n = min(self.mix["check_requests"] - 1, len(rest))
        pick = [longest] + list(rng.choice(rest, size=n, replace=False))
        return [(i, by_pool[i]) for i in pick]

    def reference_request(self, i, r) -> dict:
        """What the reference gets of served request r (pool index i): the
        raw pages, the prompt's ids and the sampling's processing."""
        p = self.pool[i]
        sp = p["sampling"]
        return {"images": p["images"], "input_ids": r.input_ids.tolist(),
                "min_pixels": 56 * 56, "max_pixels": self.mix["max_pixels"],
                "penalty": sp.repetition_penalty, "bias": dict(sp.logit_bias)}

    def check(self):
        changed = float(weights.fingerprint(self.model) != self.fingerprint)
        params = dict(self.model.named_parameters())
        gap = 0.0
        for i, r in self.judged():
            ref = reference.served_logits(params, self.ref_cfg,
                                          self.reference_request(i, r),
                                          r.output_ids, self.device)
            gap = max(gap, float(reference.token_gaps(ref,
                                                      r.output_ids).max()))
        return [("weights_changed", changed), ("answer_gap", gap)]

    def control(self, low: str = "fp8"):
        """The control's reading: at each served position of the judged
        requests, the gap of the token that the reference in `low` (w8a8)
        puts first, judged by the float32 reference."""
        params = dict(self.model.named_parameters())
        gap = 0.0
        for i, r in self.judged():
            req = self.reference_request(i, r)
            ref = reference.served_logits(params, self.ref_cfg, req,
                                          r.output_ids, self.device)
            got = reference.served_logits(params, self.ref_cfg, req,
                                          r.output_ids, self.device, low=low)
            gap = max(gap, float(reference.token_gaps(
                ref, got.argmax(dim=-1).tolist()).max()))
        return [("answer_gap", gap)]
