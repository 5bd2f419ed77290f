"""Continuous-batching inference engine over a paged KV pool.

Counterpart of visrag_tpu/serving/engine.py (the vLLM role in EVisRAG's
predict.py): requests queue, take one of `num_slots` decode slots, prefill
(whole-prompt, batched for same-bucket text prompts, or chunk by chunk for
long prompts, the vision tower running once up front), then decode
`decode_chunk` tokens per slot per dispatch with per-request sampling
(temperature, top_p, repetition penalty, logit bias). Block accounting is
the JAX engine's: prompt buckets, a null block that idle slots write into,
table rows, prefix-cache chains of full blocks keyed by chained hashes, and
n-sample prompt groups whose forks share the prompt's full blocks and copy
its partial last block.

Differences from the JAX engine:

  * the model carries its weights (an nn.Module on the engine's device);
    the pools are bf16, or int8 with per-(token, kv head) scales
    (cache_dtype="int8", serving/paged_kv.KVQuant);
  * JAX's donated per-layer pools become one preallocated layer-stacked
    tensor per K and V, written in place;
  * the decode chunk is a Python loop of device steps with no host sync
    inside it; one packed copy to the host ends the chunk;
  * random draws come from a `torch.Generator` (greedy requests draw none);
  * `_prefill_many` inserts only the cacheable span of each prompt into
    the prefix cache (the JAX engine inserts the whole ids);
  * `set_params` takes the module (updated in place by the optimizer) and
    clears the prefix cache;
  * tensor parallelism (`mesh` with a `model` axis > 1) runs one engine
    per rank of the model group, each over its shard of the weights
    (mesh.shard_module_tp: Megatron's column / row rules, heads cut
    whole) and pools that hold only the kv heads its q heads read
    (paged_kv.tp_head_layout). The JAX engine is one controller over
    GSPMD-sharded arrays. Every rank is fed the same requests and takes
    the same host decisions; the logits are gathered whole on every rank,
    every rank samples, and the group's first rank's tokens and
    log-probabilities are broadcast over the group, so that the ranks
    cannot diverge. `set_params` re-slices the shard from a whole module
    or from its FSDP2 shards (mesh.load_tp_shard).

While a torch profiler runs, each prefill entry records an
`engine.prefill` span (utils/profiling; `kind` one / many / start /
chunk, the request ids, real and padded tokens), each decode chunk an
`engine.decode` span with a `engine.decode.step` and a
`engine.decode.model` span a step, and the live slots at its start.

The engine calls only the model's `prefill` / `decode` and reads
`cfg.text` for the pool's shape, plus `prefill_chunk` and `embed_prompt`
where the model has them (Qwen25VL): it serves Qwen2.5-VL and the three
VisRAG-Gen models (MiniCPM-2B, MiniCPM-V 2.0, MiniCPM-V 2.6), whose
prompts prefill whole. `beam_search` / `beam_search_batched` run the
weighted-selection strategy's HF-parity beam search outside the slots
(serving/beam.py).
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..mesh import MODEL, axis_group, axis_size, load_tp_shard
from ..utils import profiling
from .paged_kv import (BlockAllocator, KVQuant, pool_shape, tp_head_layout,
                       write_prefill)
from .sampling import SamplingParams, bias_arrays, sample_vec

MAX_LOGIT_BIAS = 8          # (id, bias) pairs per request


def _is_int8(cache_dtype) -> bool:
    """cache_dtype → True for int8 pools, False for bf16; raises for any
    other (the decode kernel reads bf16 or int8)."""
    if cache_dtype in ("int8", torch.int8, np.int8):
        return True
    if cache_dtype in (None, "bfloat16", "bf16", torch.bfloat16):
        return False
    raise ValueError(f"cache_dtype {cache_dtype!r}: the KV pools are "
                     f"bfloat16 or int8")


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds largest bucket {buckets[-1]}")


@dataclasses.dataclass
class Request:
    request_id: int
    input_ids: np.ndarray            # (S,) prompt token ids
    positions: np.ndarray            # (3, S) mrope ids
    vision_batch: Optional[dict] = None
    slot_map: Optional[np.ndarray] = None
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    group: Optional["PromptGroup"] = None   # n-sampling fork group
    # filled by the engine:
    output_ids: List[int] = dataclasses.field(default_factory=list)
    cum_logprob: float = 0.0
    done: bool = False
    # enqueue → first-token wall times, and (wall time, n tokens) per
    # emission (tokens of one decode chunk share its completion time)
    t_enqueue: float = 0.0
    t_first: Optional[float] = None
    emits: List[Tuple[float, int]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class PromptGroup:
    """Shared prompt state for n-sampling: the leader prefills once; the
    forks share its full prompt blocks (refcounted) and copy its partial
    last block. The group holds one reference on those blocks until every
    fork is placed."""
    prompt_len: int
    shared: List[int]
    hold: List[int]
    partial_src: int                 # leader's partial block id, -1 if none
    last_logits: object = None       # (vocab,) raw prompt-end logits
    prompt_row: object = None        # (vocab,) bool seen row of the prompt
    forks_left: int = 0
    ready: bool = False


class Engine:
    """Continuous-batching engine over a fixed number of decode slots."""

    def __init__(self, model, *, num_slots: int = 8, max_len: int = 4096,
                 prompt_buckets: Sequence[int] = (512, 1024, 2048, 4096),
                 eos_token_ids: Sequence[int] = (),
                 cache_dtype=torch.bfloat16, decode_chunk: int = 16,
                 cache_blocks: Optional[int] = None,
                 prefill_token_budget: Optional[int] = None,
                 chunked_prefill_tokens: Optional[int] = None,
                 prefix_cache: bool = False, seed: int = 0, mesh=None):
        """mesh: a DeviceMesh whose `model` axis > 1 makes this rank's
        engine one of its model group's (tensor parallelism); `model` is
        then this rank's shard, as mesh.shard_module_tp cuts it."""
        self.tp = axis_size(mesh, MODEL)
        self.group = None
        tc = model.cfg.text
        kvh = tc.num_key_value_heads
        if self.tp > 1:
            if getattr(model, "tp_size", 1) != self.tp:
                raise ValueError(
                    f"a mesh with model axis {self.tp} serves a rank's "
                    "shard: pass mesh.shard_module_tp(model, mesh)")
            self.group = axis_group(mesh, MODEL)
            kvh = tp_head_layout(tc.num_attention_heads, kvh, self.tp,
                                 dist.get_rank(self.group))[3]
        self.model = model
        self.device = next(model.parameters()).device
        self.num_slots = num_slots
        self.max_len = max_len
        self.prompt_buckets = [b for b in prompt_buckets if b <= max_len]
        self.eos = set(int(e) for e in eos_token_ids)
        self.chunk = decode_chunk
        self.vocab = tc.vocab_size
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # int8 KV: pools of int8 data plus per-(token, kv head) fp32 scales,
        # quantized on write and dequantized inside the decode kernel, half
        # the bytes that decode reads (the vLLM kv_cache_dtype role)
        self.kv_quant = _is_int8(cache_dtype)
        bs = 128
        for b in list(self.prompt_buckets) + [max_len]:
            bs = np.gcd(bs, b)
        self.block_size = int(bs)
        self.max_blocks = max_len // self.block_size
        n_blocks = (cache_blocks or num_slots * self.max_blocks) + 1
        self._pool_shape = (tc.num_hidden_layers, *pool_shape(
            n_blocks, self.block_size, kvh, tc.head_dim))
        self.k_cache = self.v_cache = None
        self.wake()
        self.allocator = BlockAllocator(n_blocks)
        # idle slots write into a dedicated scratch block (never read)
        self.null_block = self.allocator.alloc(1)[0]
        self.table = np.full((num_slots, self.max_blocks), self.null_block,
                             np.int32)
        self.slot_blocks: List[List[int]] = [[] for _ in range(num_slots)]
        self.seen = torch.zeros((num_slots, self.vocab), dtype=torch.bool,
                                device=self.device)
        self._eos_t = torch.tensor(sorted(self.eos) or [-1], dtype=torch.int32,
                                   device=self.device)
        # host mirrors of per-slot decode state
        self.lengths = np.zeros((num_slots,), np.int32)
        self.cur_pos = np.zeros((num_slots,), np.int32)
        self.gen_left = np.zeros((num_slots,), np.int32)
        self.last_tok = np.zeros((num_slots,), np.int32)
        self.active = np.zeros((num_slots,), bool)
        self.temp = np.ones((num_slots,), np.float32)
        self.top_p = np.ones((num_slots,), np.float32)
        self.rep_pen = np.ones((num_slots,), np.float32)
        self.max_bias = MAX_LOGIT_BIAS
        self.bias_ids = np.zeros((num_slots, self.max_bias), np.int32)
        self.bias_vals = np.zeros((num_slots, self.max_bias), np.float32)
        self.slot_req: List[Optional[Request]] = [None] * num_slots
        self.queue: List[Request] = []
        self._next_id = 0
        self.prefill_count = 0       # full-model prompt passes
        self.prefill_dispatches = 0  # prefill model calls (batched = 1)
        # at most this many (bucketed) prefill tokens between consecutive
        # decode chunks while any slot is live; None = no bound
        self.prefill_token_budget = prefill_token_budget
        # scheduler trace: "P" prefill dispatch, "C"/"c" chunked-prefill
        # step (decodes live / idle), "D" decode chunk
        self.record_schedule = False
        self.sched_log: List[str] = []
        # chunked prefill: prompts longer than this run as ceil(s/C)
        # block-aligned chunks interleaved with decode chunks
        self.chunk_tokens = None
        if chunked_prefill_tokens and hasattr(model, "prefill_chunk"):
            C = int(chunked_prefill_tokens)
            if C % self.block_size:
                raise ValueError(f"chunked_prefill_tokens {C} must be a "
                                 f"multiple of block_size {self.block_size}")
            self.chunk_tokens = C
        self._chunking: Dict[int, dict] = {}     # slot → chunk state
        self._chunk_groups = set()               # groups mid-chunk-prefill
        # automatic prefix caching: full prompt blocks in a chained-hash
        # cache; every prompt with standard positions populates it, only
        # the chunked path matches (it is the resume mechanism)
        self._prefix_cache = None
        if prefix_cache:
            if self.chunk_tokens is None:
                raise ValueError("prefix_cache requires "
                                 "chunked_prefill_tokens (the resume path)")
            self._prefix_cache = OrderedDict()   # chain key → block id
        self.prefix_hits = 0

    # ---- pools --------------------------------------------------------

    def sleep(self) -> None:
        """Free the KV pools' device memory between runs (vLLM sleep mode).
        Needs an idle engine; the cached prefix KV dies with the pools."""
        assert all(r is None for r in self.slot_req), \
            "cannot sleep with live requests"
        if self.k_cache is None:
            return
        self._clear_prefix_cache()
        self.k_cache = self.v_cache = None

    def wake(self) -> None:
        """(Re)allocate zeroed pools; a no-op while they exist."""
        if self.k_cache is not None:
            return

        def pool():
            if not self.kv_quant:
                return torch.zeros(self._pool_shape, dtype=torch.bfloat16,
                                   device=self.device)
            return KVQuant(
                torch.zeros(self._pool_shape, dtype=torch.int8,
                            device=self.device),
                torch.zeros(self._pool_shape[:-1], dtype=torch.float32,
                            device=self.device))
        self.k_cache, self.v_cache = pool(), pool()

    def set_params(self, model) -> None:
        """Hand the engine the policy after a weight update (the RL
        trainer → rollout handoff). The optimizer updates the module's
        tensors in place, so the reference is usually the one the engine
        already holds; what has to happen is that the prefix cache goes:
        its KV was computed with the old weights, and serving it would
        silently corrupt generations. Under tensor parallelism a module
        other than the engine's shard is the whole one, or its FSDP2
        shards, and the shard is re-sliced from it in place (every rank of
        the FSDP2 mesh calls this then)."""
        self._clear_prefix_cache()
        if self.tp > 1 and model is not self.model:
            load_tp_shard(self.model, model)
        elif self.tp == 1:
            self.model = model

    def _clear_prefix_cache(self) -> None:
        if self._prefix_cache:
            for blk in self._prefix_cache.values():
                self.allocator.release([blk])
            self._prefix_cache.clear()

    # ---- request management ------------------------------------------

    def add_request(self, input_ids, positions=None, vision_batch=None,
                    slot_map=None, sampling: Optional[SamplingParams] = None,
                    n: int = 1):
        """Queue one prompt; n > 1 queues an n-sampling group (one prefill,
        n decode forks). → the request id, or the n ids for a group."""
        input_ids = np.asarray(input_ids, np.int32)
        s = len(input_ids)
        if s + 1 > self.max_len:
            raise ValueError(
                f"prompt length {s} needs {s + 1} KV slots (prompt + first "
                f"generated token) but max_len is {self.max_len}")
        can_chunk = (self.chunk_tokens is not None and s > self.chunk_tokens
                     and (vision_batch is None
                          or hasattr(self.model, "embed_prompt")))
        if not can_chunk and s > self.prompt_buckets[-1]:
            raise ValueError(
                f"prompt length {s} exceeds the largest prompt bucket "
                f"{self.prompt_buckets[-1]} and cannot take the chunked "
                f"path (chunked_prefill_tokens={self.chunk_tokens}, "
                f"vision={vision_batch is not None})")
        if positions is None:
            positions = np.broadcast_to(np.arange(s), (3, s))
        positions = np.asarray(positions)
        sampling = sampling or SamplingParams()
        if len(sampling.logit_bias) > self.max_bias:
            raise ValueError(
                f"logit_bias has {len(sampling.logit_bias)} entries; the "
                f"engine supports at most {self.max_bias}")
        group = None
        if n > 1:
            group = PromptGroup(prompt_len=s, shared=[], hold=[],
                                partial_src=-1, forks_left=n - 1)
        rids = []
        now = time.monotonic()
        for i in range(n):
            rid = self._next_id
            self._next_id += 1
            self.queue.append(Request(
                rid, input_ids, positions,
                vision_batch=vision_batch if i == 0 else None,
                slot_map=slot_map if i == 0 else None,
                sampling=sampling, group=group, t_enqueue=now))
            rids.append(rid)
        return rids if n > 1 else rids[0]

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def _chunkable(self, req: Request) -> bool:
        if self.chunk_tokens is None \
                or len(req.input_ids) <= self.chunk_tokens \
                or (req.group is not None and req.group.ready):
            return False
        return req.vision_batch is None or hasattr(self.model, "embed_prompt")

    def _budget(self, req: Request) -> int:
        sp = req.sampling
        return max(min(sp.max_tokens, self.max_len - len(req.input_ids)), 1)

    def _blocks_needed(self, req: Request) -> int:
        """Worst-case pool blocks a placement of `req` allocates (own blocks
        only: forks share the group's prompt blocks)."""
        s = len(req.input_ids)
        total = -(-(s + self._budget(req)) // self.block_size)
        g = req.group
        if g is not None and g.ready:
            return total - len(g.shared)
        if self._chunkable(req):
            C = self.chunk_tokens
            need = max(total, (-(-s // C)) * C // self.block_size)
            nc = self._cacheable_len(req) \
                if self._prefix_cache is not None else 0
            if nc:
                # discount the blocks a prefix-cache hit will share
                m = len(self._match_prefix(req.input_ids[:nc]))
                lo0 = min((m * self.block_size) // C * C, (s - 1) // C * C)
                need -= lo0 // self.block_size
            return need
        bucket = _bucket(s, self.prompt_buckets)
        return max(bucket // self.block_size, total)

    def _can_place(self, req: Request) -> bool:
        return self._blocks_needed(req) <= len(self.allocator.free)

    # ---- device helpers ----------------------------------------------

    def _dev(self, a, dtype=None):
        t = torch.as_tensor(np.asarray(a), device=self.device)
        return t if dtype is None else t.to(dtype)

    def _vision(self, req: Request):
        return {k: self._dev(v) for k, v in req.vision_batch.items()}

    def _sample(self, logits, prows, sps: Sequence[SamplingParams],
                bias_ids, bias_vals):
        """Bias the raw logits (K, V), sample one token per row with the
        requests' parameters and the prompt rows as the seen mask."""
        biased = logits.scatter_add(
            1, self._dev(bias_ids, torch.int64),
            self._dev(bias_vals).to(logits.dtype))
        temp = np.asarray([sp.temperature for sp in sps], np.float32)
        top_p = np.asarray([sp.top_p for sp in sps], np.float32)
        rp = np.asarray([sp.repetition_penalty for sp in sps], np.float32)
        return self._agree(*sample_vec(
            biased, self._dev(temp), self._dev(top_p), self._dev(rp), prows,
            generator=self.generator, all_greedy=bool((temp == 0).all()),
            any_top_p=bool((top_p < 1).any())))

    def _agree(self, tok, logp):
        """Under tensor parallelism: the group's first rank's tokens and
        log-probabilities, broadcast (every rank drew them from the same
        logits and generator; the broadcast makes a divergence impossible,
        not merely unlikely). One collective, no host sync on NCCL."""
        if self.tp == 1:
            return tok, logp
        both = torch.stack([tok.to(torch.int32),
                            logp.float().view(torch.int32)])
        dist.broadcast(both, dist.get_global_rank(self.group, 0),
                       group=self.group)
        return both[0], both[1].view(torch.float32)

    def _first_token(self, logits, prow, slot: int, sp: SamplingParams):
        """Sample a slot's first token from prompt-end logits (V,) and
        install its seen row."""
        b_ids, b_vals = bias_arrays(sp, self.max_bias)
        tok, logp = self._sample(logits[None], prow[None], [sp], b_ids[None],
                                 b_vals[None])
        row = prow.clone()
        row[tok[0].long()] = True
        self.seen[slot] = row
        return tok[0], logp[0]

    # ---- prefill -----------------------------------------------------

    def _alloc_slot(self, slot: int, need: int) -> List[int]:
        blocks = self.allocator.alloc(need)
        self.slot_blocks[slot] = blocks
        self.table[slot] = self.null_block
        self.table[slot, :need] = blocks
        return blocks

    def _prefill_one(self, req: Request, slot: int) -> int:
        s = len(req.input_ids)
        bucket = _bucket(s, self.prompt_buckets)
        with profiling.span("engine.prefill", kind="one",
                            rid=req.request_id, tokens=s, padded=bucket):
            ids = np.zeros((1, bucket), np.int32)
            ids[0, :s] = req.input_ids
            pos = np.zeros((3, 1, bucket), np.int32)
            pos[:, 0, :s] = req.positions
            mask = np.zeros((1, bucket), np.int32)
            mask[0, :s] = 1
            vb = sm = None
            if req.vision_batch is not None:
                vb = self._vision(req)
                sm = np.full((1, bucket), -1, np.int32)
                sm[0, :s] = req.slot_map
                sm = self._dev(sm)
            bs_blk = self.block_size
            need = max(-(-bucket // bs_blk),
                       -(-(s + self._budget(req)) // bs_blk))
            blocks = self._alloc_slot(slot, need)
            last, k, v = self.model.prefill(
                self._dev(ids), attention_mask=self._dev(mask),
                positions=self._dev(pos), vision_batch=vb, slot_map=sm,
                last_pos=self._dev([s - 1]))
            write_prefill(self.k_cache, self.v_cache, k, v,
                          blocks[:bucket // bs_blk], bucket)
            del k, v
            prow = torch.zeros((self.vocab,), dtype=torch.bool,
                               device=self.device)
            prow[self._dev(req.input_ids, torch.int64)] = True
            tok, logp = self._first_token(last[0], prow, slot, req.sampling)
            self.prefill_count += 1
            self.prefill_dispatches += 1
            if self._prefix_cache is not None:
                nc = self._cacheable_len(req)
                if nc:
                    self._insert_prefix(req.input_ids[:nc], blocks)
            self._publish_group(req, blocks, s, last[0], prow)
            return self._activate_slot(req, slot, tok, logp, s)

    def _publish_group(self, req: Request, blocks, s: int, last, prow):
        """Group leader: publish the shared prompt blocks and prompt-end
        state so forks place without a model forward."""
        g = req.group
        if g is None or g.ready:
            return
        nfull = s // self.block_size
        g.shared = blocks[:nfull]
        g.partial_src = blocks[nfull] if s % self.block_size else -1
        g.hold = list(g.shared) + \
            ([g.partial_src] if g.partial_src >= 0 else [])
        self.allocator.retain(g.hold)
        g.last_logits = last
        g.prompt_row = prow
        g.ready = True

    def _prefill_many(self, reqs: List[Request], slots: List[int]):
        """K same-bucket text prompts in ONE batched prefill."""
        K = len(reqs)
        bucket = _bucket(max(len(r.input_ids) for r in reqs),
                         self.prompt_buckets)
        with profiling.span(
                "engine.prefill", kind="many",
                rid=tuple(r.request_id for r in reqs),
                tokens=tuple(len(r.input_ids) for r in reqs),
                padded=K * bucket):
            bs_blk = self.block_size
            nb = bucket // bs_blk
            ids = np.zeros((K, bucket), np.int32)
            pos = np.zeros((3, K, bucket), np.int32)
            mask = np.zeros((K, bucket), np.int32)
            rows = np.zeros((K, nb), np.int32)
            lens = np.zeros((K,), np.int32)
            b_ids = np.zeros((K, self.max_bias), np.int32)
            b_vals = np.zeros((K, self.max_bias), np.float32)
            blocks_per = []
            for i, (req, slot) in enumerate(zip(reqs, slots)):
                s = len(req.input_ids)
                ids[i, :s] = req.input_ids
                pos[:, i, :s] = req.positions
                mask[i, :s] = 1
                lens[i] = s
                b_ids[i], b_vals[i] = bias_arrays(req.sampling, self.max_bias)
                need = max(nb, -(-(s + self._budget(req)) // bs_blk))
                blocks = self._alloc_slot(slot, need)
                rows[i] = blocks[:nb]
                blocks_per.append(blocks)
            last, k, v = self.model.prefill(
                self._dev(ids), attention_mask=self._dev(mask),
                positions=self._dev(pos), last_pos=self._dev(lens - 1))
            write_prefill(self.k_cache, self.v_cache, k, v, rows, bucket)
            del k, v
            rr, cc = np.nonzero(mask)          # the prompts' real tokens only
            prows = torch.zeros((K, self.vocab), dtype=torch.bool,
                                device=self.device)
            prows[self._dev(rr, torch.int64), self._dev(ids[rr, cc],
                                                        torch.int64)] = True
            tok, logp = self._sample(last, prows, [r.sampling for r in reqs],
                                     b_ids, b_vals)
            rows_seen = prows.clone()
            rows_seen[torch.arange(K, device=self.device), tok.long()] = True
            self.seen[self._dev(slots, torch.int64)] = rows_seen
            self.prefill_count += K
            self.prefill_dispatches += 1
            toks, logps = tok.cpu().numpy(), logp.cpu().numpy()
            for i, (req, slot) in enumerate(zip(reqs, slots)):
                if self._prefix_cache is not None:
                    nc = self._cacheable_len(req)
                    if nc:
                        self._insert_prefix(req.input_ids[:nc], blocks_per[i])
                self._publish_group(req, blocks_per[i], len(req.input_ids),
                                    last[i], prows[i])
                self._activate_slot(req, slot, toks[i], logps[i],
                                    len(req.input_ids))

    def _place_fork(self, req: Request, slot: int) -> int:
        """One decode fork of a prefilled group: share the full prompt
        blocks, copy the partial last block, sample its first token from the
        group's prompt-end logits; no model forward."""
        g = req.group
        s = g.prompt_len
        need = -(-(s + self._budget(req)) // self.block_size)
        own = self.allocator.alloc(need - len(g.shared))
        self.allocator.retain(g.shared)
        blocks = list(g.shared) + own
        self.slot_blocks[slot] = blocks
        self.table[slot] = self.null_block
        self.table[slot, :len(blocks)] = blocks
        if g.partial_src >= 0:
            self.k_cache[:, own[0]] = self.k_cache[:, g.partial_src]
            self.v_cache[:, own[0]] = self.v_cache[:, g.partial_src]
        tok, logp = self._first_token(g.last_logits, g.prompt_row, slot,
                                      req.sampling)
        g.forks_left -= 1
        if g.forks_left == 0:
            self.allocator.release(g.hold)
            g.hold = []
        return self._activate_slot(req, slot, tok, logp, s)

    # ---- prefix cache --------------------------------------------------

    @staticmethod
    def _default_positions(req: Request) -> bool:
        s = len(req.input_ids)
        return bool(np.array_equal(
            req.positions, np.broadcast_to(np.arange(s), (3, s))))

    def _cacheable_len(self, req: Request) -> int:
        """Tokens from 0 whose K/V depends on the ids alone: the whole of a
        text prompt with standard positions; the span before the first
        image token of a vision prompt (0 if its positions there are not
        the text arange)."""
        s = len(req.input_ids)
        if req.vision_batch is None:
            return s if self._default_positions(req) else 0
        vis = np.nonzero(np.asarray(req.slot_map) >= 0)[0]
        n = int(vis[0]) if len(vis) else s
        if n and np.array_equal(req.positions[:, :n],
                                np.broadcast_to(np.arange(n), (3, n))):
            return n
        return 0

    def _chain_keys(self, ids: np.ndarray):
        """Chained per-block hash keys over the prompt's FULL blocks."""
        bs = self.block_size
        key = b""
        for j in range(len(ids) // bs):
            key = hashlib.sha1(
                key + ids[j * bs:(j + 1) * bs].tobytes()).digest()
            yield key

    def _match_prefix(self, ids: np.ndarray) -> List[int]:
        """Longest cached chain for this prompt (matched entries move to
        most recently used); hits are counted by the caller."""
        blocks: List[int] = []
        for key in self._chain_keys(np.asarray(ids, np.int32)):
            blk = self._prefix_cache.get(key)
            if blk is None:
                break
            self._prefix_cache.move_to_end(key)
            blocks.append(blk)
        return blocks

    def _insert_prefix(self, ids: np.ndarray, blocks: List[int]) -> None:
        for j, key in enumerate(self._chain_keys(np.asarray(ids, np.int32))):
            if key in self._prefix_cache:
                self._prefix_cache.move_to_end(key)
                continue
            self._prefix_cache[key] = blocks[j]
            self.allocator.retain([blocks[j]])   # the cache's own reference

    def _evict_prefix(self, blocks_needed: int) -> None:
        """LRU-evict cached blocks until the pool can serve the request."""
        while self._prefix_cache and \
                len(self.allocator.free) < blocks_needed:
            _key, blk = self._prefix_cache.popitem(last=False)
            self.allocator.release([blk])

    # ---- chunked prefill -----------------------------------------------

    def _start_chunked(self, req: Request, slot: int) -> None:
        """Claim a slot and blocks for chunk-at-a-time prefill. The slot's
        public table row stays on the null block until the final chunk
        lands. With the prefix cache, cached full blocks below the first
        uncached chunk boundary are shared and prefill resumes there."""
        with profiling.span("engine.prefill", kind="start",
                            rid=req.request_id):
            s = len(req.input_ids)
            bs_blk = self.block_size
            C = self.chunk_tokens
            shared: List[int] = []
            nc = self._cacheable_len(req) \
                if self._prefix_cache is not None else 0
            if nc:
                shared = self._match_prefix(req.input_ids[:nc])
            lo0 = (len(shared) * bs_blk) // C * C
            lo0 = min(lo0, (s - 1) // C * C)
            shared = shared[:lo0 // bs_blk]
            self.prefix_hits += len(shared)
            grid_hi = lo0 + -(-(s - lo0) // C) * C
            need = max(-(-(s + self._budget(req)) // bs_blk),
                       grid_hi // bs_blk)
            if shared:
                self.allocator.retain(shared)
            blocks = shared + self.allocator.alloc(need - len(shared))
            self.slot_blocks[slot] = blocks
            self.slot_req[slot] = req
            self.active[slot] = False
            self.lengths[slot] = 0
            self.table[slot] = self.null_block
            embeds = None
            if req.vision_batch is not None:
                # the vision tower once, up front; chunks slice this table
                ids = np.zeros((1, grid_hi), np.int32)
                ids[0, :s] = req.input_ids
                sm = np.full((1, grid_hi), -1, np.int32)
                sm[0, :s] = req.slot_map
                embeds = self.model.embed_prompt(
                    self._dev(ids), self._vision(req), self._dev(sm))
            self._chunking[slot] = dict(req=req, blocks=blocks, lo=lo0, s=s,
                                        embeds=embeds)
            if req.group is not None:
                self._chunk_groups.add(id(req.group))

    def _advance_chunk(self, slot: int) -> None:
        st = self._chunking[slot]
        req, C = st["req"], self.chunk_tokens
        lo, s = st["lo"], st["s"]
        bs_blk = self.block_size
        hi = min(lo + C, s)
        with profiling.span("engine.prefill", kind="chunk",
                            rid=req.request_id, tokens=hi - lo, padded=C):
            ids = np.zeros((1, C), np.int32)
            ids[0, :hi - lo] = req.input_ids[lo:hi]
            pos = np.zeros((3, 1, C), np.int32)
            pos[:, 0, :hi - lo] = req.positions[:, lo:hi]
            if hi - lo < C:
                # pad positions continue monotonically (their K/V lands in
                # the decode region and is overwritten token by token)
                pad = np.arange(1, C - (hi - lo) + 1, dtype=np.int32)
                pos[:, 0, hi - lo:] = pos[:, 0, hi - lo - 1:hi - lo] + pad
            blocks = st["blocks"]
            final = hi >= s
            emb = None if st["embeds"] is None \
                else st["embeds"][:, lo:lo + C]
            logits = self.model.prefill_chunk(
                self._dev(ids), self._dev(pos), self.k_cache, self.v_cache,
                self._dev(blocks[lo // bs_blk:(lo + C) // bs_blk],
                          torch.int64),
                self._dev(blocks[:(lo + C) // bs_blk], torch.int64),
                self._dev(lo, torch.int32),
                last_pos=self._dev([s - 1 - lo]) if final else None,
                inputs_embeds=emb)
            st["lo"] = lo + C
            self.prefill_dispatches += 1
            if not final:
                return
            del self._chunking[slot]
            self.prefill_count += 1
            if len(blocks) > self.max_blocks:
                # the C-aligned grid can round past max_len; the excess
                # blocks hold only pad K/V that lengths never reach
                self.allocator.release(blocks[self.max_blocks:])
                blocks = blocks[:self.max_blocks]
                self.slot_blocks[slot] = blocks
            self.table[slot, :len(blocks)] = blocks
            if self._prefix_cache is not None:
                nc = self._cacheable_len(req)
                if nc:
                    self._insert_prefix(req.input_ids[:nc], blocks)
            prow = torch.zeros((self.vocab,), dtype=torch.bool,
                               device=self.device)
            prow[self._dev(req.input_ids, torch.int64)] = True
            tok, logp = self._first_token(logits[0], prow, slot, req.sampling)
            if req.group is not None:
                self._chunk_groups.discard(id(req.group))
                self._publish_group(req, blocks, s, logits[0], prow)
            self._activate_slot(req, slot, tok, logp, s)

    def _activate_slot(self, req: Request, slot: int, tok, logp,
                       s: int) -> int:
        """Bookkeeping after a prefill or a fork placed a request."""
        sp = req.sampling
        tok = int(tok)
        req.cum_logprob += float(logp)
        req.output_ids.append(tok)
        req.t_first = time.monotonic()
        req.emits.append((req.t_first, 1))
        self.slot_req[slot] = req
        self.lengths[slot] = s
        self.cur_pos[slot] = int(req.positions.max()) + 1
        self.gen_left[slot] = sp.max_tokens - 1
        self.last_tok[slot] = tok
        self.temp[slot] = sp.temperature
        self.top_p[slot] = sp.top_p
        self.rep_pen[slot] = sp.repetition_penalty
        self.bias_ids[slot], self.bias_vals[slot] = \
            bias_arrays(sp, self.max_bias)
        done = (tok in self.eos or sp.max_tokens <= 1
                or s + 1 >= self.max_len)
        self.active[slot] = not done
        if done:
            req.done = True
            self._finish_slot(slot)
        return tok

    def _finish_slot(self, slot: int) -> None:
        self.slot_req[slot] = None
        self.allocator.release(self.slot_blocks[slot])
        self.slot_blocks[slot] = []
        self.table[slot] = self.null_block
        self.lengths[slot] = 0

    # ---- decode --------------------------------------------------------

    def _decode_chunk(self) -> None:
        """`decode_chunk` steps for all slots on the device, then ONE packed
        copy to the host: [tokens (T*B) | lengths | cur_pos | gen_left |
        active | last_tok | logp bits]. Inactive slots re-write their own
        last position (or the null block) and record nothing."""
        if profiling.recording():
            profiling.count("engine.live_slots", int(self.active.sum()))
        with profiling.span("engine.decode", steps=self.chunk):
            B, T = self.num_slots, self.chunk
            # the table's live columns, rounded up to a power of two
            need = int(self.lengths.max()) + T + 1
            mbk = 1
            while mbk * self.block_size < need and mbk < self.max_blocks:
                mbk *= 2
            mbk = min(mbk, self.max_blocks)
            table = self._dev(np.ascontiguousarray(self.table[:, :mbk]))
            lengths = self._dev(self.lengths)
            last_tok = self._dev(self.last_tok)
            cur_pos = self._dev(self.cur_pos)
            active = self._dev(self.active)
            gen_left = self._dev(self.gen_left)
            temp, top_p = self._dev(self.temp), self._dev(self.top_p)
            rep_pen = self._dev(self.rep_pen)
            bias_ids = self._dev(self.bias_ids, torch.int64)
            bias_vals = self._dev(self.bias_vals)
            all_greedy = bool((self.temp == 0).all())
            any_top_p = bool((self.top_p < 1).any())
            rows = torch.arange(B, device=self.device)
            logp_acc = torch.zeros((B,), dtype=torch.float32,
                                   device=self.device)
            toks = []
            for _ in range(T):
                with profiling.span("engine.decode.step"):
                    lengths_incl = torch.clamp(lengths + active.int(), min=1)
                    pos3 = cur_pos[None, :, None].expand(3, B, 1)
                    with profiling.span("engine.decode.model"):
                        logits = self.model.decode(
                            last_tok[:, None], pos3, self.k_cache,
                            self.v_cache, lengths_incl, table)
                    logits = logits.scatter_add(1, bias_ids,
                                                bias_vals.to(logits.dtype))
                    tok, logp = self._agree(*sample_vec(
                        logits, temp, top_p, rep_pen, self.seen,
                        generator=self.generator, all_greedy=all_greedy,
                        any_top_p=any_top_p))
                    tok = torch.where(active, tok, last_tok)
                    self.seen[rows, tok.long()] |= active
                    toks.append(torch.where(active, tok,
                                            torch.full_like(tok, -1)))
                    is_eos = (tok[:, None] == self._eos_t[None, :]).any(-1)
                    step = active.int()
                    lengths = lengths + step
                    cur_pos = cur_pos + step
                    gen_left = gen_left - step
                    logp_acc = logp_acc + torch.where(active, logp,
                                                      torch.zeros_like(logp))
                    active = active & ~is_eos & (gen_left > 0) & \
                        (lengths + 1 < self.max_len)
                    last_tok = tok
            packed = torch.cat([torch.stack(toks).reshape(-1), lengths,
                                cur_pos, gen_left, active.int(), last_tok,
                                logp_acc.view(torch.int32)]).cpu().numpy()
            toks_np = packed[:T * B].reshape(T, B)
            off = T * B
            self.lengths = packed[off:off + B].astype(np.int32)
            self.cur_pos = packed[off + B:off + 2 * B].astype(np.int32)
            self.gen_left = packed[off + 2 * B:off + 3 * B].astype(np.int32)
            new_active = packed[off + 3 * B:off + 4 * B].astype(bool)
            self.last_tok = packed[off + 4 * B:off + 5 * B].astype(np.int32)
            logp_np = packed[off + 5 * B:off + 6 * B].view(np.float32)
            toks_T = np.ascontiguousarray(toks_np.T)
            now = time.monotonic()
            for i in range(B):
                req = self.slot_req[i]
                if req is None or i in self._chunking:
                    # mid-chunk-prefill slots are decode-inactive by design
                    continue
                row = toks_T[i]
                new_toks = row[row >= 0].tolist()
                req.output_ids.extend(new_toks)
                if new_toks:
                    req.emits.append((now, len(new_toks)))
                req.cum_logprob += float(logp_np[i])
                if not new_active[i]:
                    req.done = True
                    self._finish_slot(i)
            self.active = new_active & np.asarray(
                [r is not None for r in self.slot_req])

    # ---- main loop ---------------------------------------------------

    @torch.no_grad()
    def run(self) -> Dict[int, List[int]]:
        """Drain the queue → {request_id: output token ids}."""
        self.wake()
        results: Dict[int, List[int]] = {}
        pending = {r.request_id: r for r in self.queue}
        while self.queue or any(r is not None for r in self.slot_req):
            budget = self.prefill_token_budget
            spent = 0
            while self.queue and self._free_slots():
                head = self.queue[0]
                if (budget is not None and spent >= budget
                        and any(r is not None for r in self.slot_req)
                        and not (head.group is not None
                                 and head.group.ready)):
                    break
                free = self._free_slots()
                if not self._can_place(head) and self._prefix_cache:
                    self._evict_prefix(self._blocks_needed(head))
                if not self._can_place(head):
                    # backpressure: wait for running slots to free blocks
                    if not any(r is not None for r in self.slot_req):
                        raise RuntimeError(
                            f"KV pool too small for request "
                            f"{head.request_id}: needs "
                            f"{self._blocks_needed(head)} blocks, pool has "
                            f"{len(self.allocator.free)} free with no "
                            f"running requests to wait for")
                    break
                if head.group is not None and head.group.ready:
                    self._place_fork(self.queue.pop(0), free[0])
                    continue
                if head.group is not None and \
                        id(head.group) in self._chunk_groups:
                    break        # the leader is mid-chunk-prefill
                if self._chunkable(head):
                    self._start_chunked(self.queue.pop(0), free[0])
                    continue
                head_bucket = _bucket(len(head.input_ids),
                                      self.prompt_buckets)
                batch = self._batchable(head, free, budget, spent,
                                        head_bucket)
                K = 1 << (max(len(batch), 1).bit_length() - 1)
                if K >= 2 and batch[0] is head:
                    reqs = batch[:K]
                    for r in reqs:
                        self.queue.remove(r)
                    self._prefill_many(reqs, free[:K])
                    spent += K * head_bucket
                else:
                    self._prefill_one(self.queue.pop(0), free[0])
                    spent += head_bucket
                if self.record_schedule:
                    self.sched_log.append("P")
            # one chunk per chunking slot per iteration, budget-accounted
            for slot in list(self._chunking):
                if budget is not None and spent >= budget and \
                        bool(self.active.any()):
                    break
                live = bool(self.active.any())
                self._advance_chunk(slot)
                spent += self.chunk_tokens
                if self.record_schedule:
                    self.sched_log.append("C" if live else "c")
            if bool(self.active.any()):
                self._decode_chunk()
                if self.record_schedule:
                    self.sched_log.append("D")
            for rid, r in list(pending.items()):
                if r.done:
                    results[rid] = r.output_ids
                    del pending[rid]
        return results

    def _batchable(self, head: Request, free: List[int], budget, spent: int,
                   head_bucket: int) -> List[Request]:
        """Same-bucket, vision-free, non-fork prompts from the queue's first
        32 (one leader per group) for one batched prefill, at most 8 and
        within the pool and the prefill budget."""
        batch: List[Request] = []
        max_k = 8
        if budget is not None:
            max_k = max(1, (budget - spent) // head_bucket)
        if head.vision_batch is not None or len(free) < 2:
            return batch
        groups_seen = set()
        blocks_left = len(self.allocator.free)
        for r in self.queue[:32]:
            if len(batch) >= min(len(free), 8, max_k):
                break
            if r.group is not None and not r.group.ready:
                # only the group's first queued member (its leader) may
                # prefill
                if id(r.group) in groups_seen:
                    continue
                groups_seen.add(id(r.group))
            if (r.vision_batch is not None
                    or (r.group is not None and r.group.ready)
                    or self._chunkable(r)
                    or len(r.input_ids) > self.prompt_buckets[-1]
                    or _bucket(len(r.input_ids),
                               self.prompt_buckets) != head_bucket):
                continue
            need_r = self._blocks_needed(r)
            if need_r > blocks_left:
                break
            blocks_left -= need_r
            batch.append(r)
        return batch

    def _add_all(self, prompts: Sequence[dict], sampling, n: int) -> List[int]:
        ids: List[int] = []
        for p in prompts:
            r = self.add_request(sampling=sampling, n=n, **p)
            ids.extend(r if isinstance(r, list) else [r])
        return ids

    def generate(self, prompts: Sequence[dict],
                 sampling: Optional[SamplingParams] = None,
                 n: int = 1) -> List[List[int]]:
        """prompts: dicts with input_ids [+ positions, vision_batch,
        slot_map]. → outputs in order; n > 1 gives n consecutive samples
        per prompt (one prefill per prompt)."""
        ids = self._add_all(prompts, sampling, n)
        results = self.run()
        return [results[i] for i in ids]

    def beam_search(self, prompt: dict, *, num_beams: int = 3,
                    max_new_tokens: int = 64,
                    repetition_penalty: float = 1.2,
                    length_penalty: float = 1.0):
        """Beam-scored generation for ONE prompt → (output ids,
        sequences_score): the reference's weighted-selection scoring (HF
        generate num_beams=3, repetition_penalty=1.2). Runs outside the
        slots on dense per-beam caches (serving/beam.py)."""
        from .beam import beam_search
        return beam_search(
            self.model, prompt["input_ids"], prompt.get("positions"),
            vision_batch=prompt.get("vision_batch"),
            slot_map=prompt.get("slot_map"), num_beams=num_beams,
            max_new_tokens=max_new_tokens, eos_token_ids=sorted(self.eos),
            repetition_penalty=repetition_penalty,
            length_penalty=length_penalty)

    def beam_search_batched(self, prompts: Sequence[dict], *,
                            num_beams: int = 3, max_new_tokens: int = 64,
                            repetition_penalty: float = 1.2,
                            length_penalty: float = 1.0,
                            max_batch: int = 8):
        """`beam_search` over many prompts with each token's decode steps
        batched (P*k,): ids and scores equal the sequential path's.
        `max_batch` chunks the prompt list to bound the dense caches."""
        from .beam import beam_search_batched
        out = []
        for i in range(0, len(prompts), max_batch):
            out.extend(beam_search_batched(
                self.model,
                [dict(input_ids=p["input_ids"],
                      positions=p.get("positions"),
                      vision_batch=p.get("vision_batch"),
                      slot_map=p.get("slot_map"))
                 for p in prompts[i:i + max_batch]],
                num_beams=num_beams, max_new_tokens=max_new_tokens,
                eos_token_ids=sorted(self.eos),
                repetition_penalty=repetition_penalty,
                length_penalty=length_penalty))
        return out

    def generate_detailed(self, prompts: Sequence[dict],
                          sampling: Optional[SamplingParams] = None,
                          n: int = 1) -> List[Request]:
        """Like generate() but → the Request objects (output_ids,
        cum_logprob, latency bookkeeping)."""
        ids = self._add_all(prompts, sampling, n)
        by_id = {r.request_id: r for r in self.queue}
        self.run()
        return [by_id[i] for i in ids]
