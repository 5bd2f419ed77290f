"""RS-GRPO trainer: the RL loop on one GPU or across ranks.

Counterpart of visrag_tpu/rl/trainer.py (which replaces the reference's
Ray/FSDP/vLLM machinery: verl/trainer/ray_trainer.py:560-704,
workers/fsdp_workers.py, actor/dp_actor.py:219-302):

  rollout (serving.Engine, n samples/prompt, persistent across steps)
    → rewards (host: scoped channels, rl/rewards.py)
    → online filtering pulling FRESH prompt groups per retry with globally
      unique uids (ray_trainer._make_batch_data :467-558)
    → ROUTER/GRPO advantage (rl/advantage.py), or GAE from the critic's
      values (rl/critic.py), the critic trained after the actor
    → seqlen-balanced reorder across dp ranks (ray_trainer._balance_batch
      :450-465) → minibatch / token-budget micro-batch loops with
      dual-clip PPO (dp_actor.update_policy :219-302).

Token alignment: log-probs live at position t for the token generated at
t+1 (the label shift), so the update path shifts response/reward masks into
the same space — ratio, advantage scope, and token counts all refer to the
same generated token.

Padding-free: micro-batches run packed (rl/packing.py) through the
segment-id attention kernels (ops/attention.py, K4, forward and backward).
Micro-batches carrying a raw `vision_batch`, and `padding_free=False`, take
the padded layout, whose attention is the valid-length kernel K1 with its
backward K2 (ops/attention_lengths.py), at the text model's d = 128 with
grouped kv heads.

Across ranks (`mesh`, one process per GPU; the JAX trainer's GSPMD batch
is logically global, and so is this one's):

  * the actor's and the reference policy's text layers are sharded by
    FSDP2 over every rank that holds the weights, (replica, data, seq), as
    SFT's are; the frozen vision tower stays whole on every rank;
  * the rollout: rank i of (replica, data) rolls out its contiguous share
    of the step's prompts (only the first seq rank of a data slot; the
    others wait) on a whole copy of the actor that the engine reads and
    that every rank refills from the sharded weights after an update (the
    JAX trainer's rollout_model and Engine.set_params); the engine itself
    issues no collective. With a mesh `model` axis > 1 (the hybrid engine,
    rollout.tensor_parallel_size) the copy is each rank's tensor-parallel
    shard of the actor (mesh.shard_module_tp) and the ranks of a model
    group run one engine over their shards; the refill keeps each rank's
    slice of every gathered tensor. The update stays FSDP2 over (replica,
    data, seq): the model ranks of a slot replicate it on the same rows.
    The sampler is seeded from the step's seed and i (i = 0: the step's
    seed, as one process; every rank of a model group shares i). The
    responses are gathered in rank order, so that every rank holds the
    step's global batch in the one-process order, and rewards, advantages
    and GAE run on it;
  * log-probs, the update and the critic take the micro-batches that one
    process would form on the global minibatch; each is padded to a
    multiple of dp with rows that count nothing and split over (replica,
    data), and at seq > 1 its sequence is padded to a multiple of seq and
    the model runs sequence-parallel (`sp_mesh`: Ulysses or ring); the
    PPO denominators are the micro-batch's over the ranks (rl/ppo.py), the
    backward is scaled by the rank count (FSDP2 averages), and log-probs
    and values are gathered back to the global batch;
  * checkpoints hold the full tensors (rank 0 writes the one-process
    format; every rank loads).

What differs from the JAX trainer:

  * the model is an nn.Module that carries its weights; the optimizer
    updates them in place, so on one GPU the engine sees the new policy
    without a copy, and `Engine.set_params` only clears the prefix cache;
  * gradients accumulate into `.grad` across micro-batches (JAX: a donated
    accumulator); a non-finite gradient norm skips `optimizer.step()`
    entirely, so parameters and optimizer state stay untouched;
  * the frozen vision tower is `requires_grad_(False)` and never enters the
    optimizer (no zero gradients, no weight-decay drift);
  * `offload_frozen_params` / `offload_ref_params` move the module to the
    CPU and back at the JAX trainer's points;
  * rows are padded to a multiple of dp, not to dp times a power of two:
    nothing is compiled per shape;
  * randomness is a `torch.Generator` on the CPU: each rollout reseeds the
    engine's generator from a draw of it, and its state rides in the
    checkpoint;
  * `rollout.tensor_parallel_size > 1` without a mesh `model` axis of
    that size, `adv_estimator="gae"` without a critic, and a critic with
    another estimator (the JAX trainer ignores it), raise ValueError.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from ..config import RLConfig
from ..mesh import (BATCH_AXES, MODEL, SEQ, WEIGHT_AXES, all_gather_rows,
                    axis_group, axis_index, axis_size)
from ..serving.engine import Engine
from ..serving.sampling import SamplingParams, banned_ids_bias
from ..training.optim import (adamw_from_config,
                              constant_schedule_with_warmup,
                              resolve_warmup_steps)
from ..training.trainer import clip_by_global_norm_
from .advantage import compute_advantage
from .packing import pack_sequences
from .ppo import group_sum, next_token_log_probs, ppo_loss, seq_block
from .reward_manager import RewardManager
from .rewards import build_reward_masks
from .seqlen import reorder_for_dp, token_budget_micro_batches

# batch keys indexed by row (dim 0); "positions" is (3, bs, S) → dim 1
_ROW_KEYS = ("input_ids", "attention_mask", "response_mask", "reward_masks",
             "advantages", "old_log_probs", "ref_log_probs", "reward_tensor",
             "uid", "slot_map", "values", "returns", "reward_baselines")


def _reindex(batch: Dict[str, np.ndarray], idx) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in batch.items():
        if k == "positions":
            out[k] = v[:, idx]
        elif k in _ROW_KEYS:
            out[k] = v[idx]
        else:
            out[k] = v
    return out


def _draw_seed(rng: torch.Generator) -> int:
    """One 62-bit seed from the generator (the role of jax.random.split)."""
    return int(torch.randint(0, 2 ** 62, (1,), generator=rng).item())


# per-token arrays of a micro-batch, sequence last (advantages too when
# they are per token)
_PER_TOKEN = ("input_ids", "attention_mask", "positions", "response_mask",
              "reward_masks", "segment_ids", "slot_map", "old_log_probs",
              "ref_log_probs", "values", "returns")


def _rank_seed(seed: int, i: int) -> int:
    """The rollout sampler's seed on rank i of (replica, data): the step's
    seed at i = 0 (one process's stream), a golden-ratio step apart on
    the others."""
    return (int(seed) + i * 0x9E3779B97F4A7C15) % 2 ** 63


def rank_part(micro: Dict[str, np.ndarray], mesh, axes, seq: bool):
    """A micro-batch's host arrays → this rank's part: the rows padded to a
    multiple of the ranks over `axes` with rows that count nothing (zeros;
    slot map -1, a text position), this rank's contiguous block of them,
    and with `seq` every per-token array padded to a multiple of the mesh's
    seq size (the sequence-parallel model takes this rank's block itself).
    positions (3, R, S) keep their rows on dim 1; entries that are not
    numpy arrays (vision_embeds) pass whole."""
    k = axis_size(mesh, *axes)
    n = len(micro["input_ids"])
    rows = -(-n // k) * k
    per, i = rows // k, axis_index(mesh, *axes)
    n_seq = axis_size(mesh, SEQ) if seq else 1
    out = {}
    for key, v in micro.items():
        if not isinstance(v, np.ndarray):
            out[key] = v
            continue
        fill = -1 if key == "slot_map" else 0
        rd = 1 if key == "positions" else 0
        pad = [(0, 0)] * v.ndim
        pad[rd] = (0, rows - n)
        if key in _PER_TOKEN or (key == "advantages" and v.ndim == 3):
            pad[-1] = (0, -v.shape[-1] % n_seq)
        v = np.pad(v, pad, constant_values=fill)
        idx = [slice(None)] * v.ndim
        idx[rd] = slice(i * per, (i + 1) * per)
        out[key] = v[tuple(idx)]
    return out


def gather_parts(x: torch.Tensor, mesh, n_seq: int) -> torch.Tensor:
    """Every rank's (b, s) block of a micro-batch's per-token output → the
    whole (R, n_seq · s): row blocks in (replica, data) order, sequence
    blocks in seq order (n_seq 1: each rank holds whole rows of its own)."""
    b, s = x.shape
    parts = all_gather_rows(x[None], axis_group(mesh, *WEIGHT_AXES))
    k = parts.shape[0] // n_seq
    return parts.view(k, n_seq, b, s).permute(0, 2, 1, 3) \
        .reshape(k * b, n_seq * s)


@dataclasses.dataclass
class RolloutBatch:
    """The in-memory payload of one rollout: plain arrays."""
    input_ids: np.ndarray        # (bs, S) prompt+response, right-padded
    attention_mask: np.ndarray   # (bs, S)
    positions: np.ndarray        # (3, bs, S)
    response_mask: np.ndarray    # (bs, S) 1 on response tokens
    responses: List[List[int]]
    response_texts: List[str]
    uid: np.ndarray              # (bs,) prompt group ids (globally unique)
    ground_truths: List[str]
    # multimodal: ONE combined vision table for the whole rollout + per-row
    # flat slot maps into it (-1 = text position); None for text-only
    vision: Optional[dict] = None
    slot_map: Optional[np.ndarray] = None


class RLTrainer:
    def __init__(self, model, cfg: RLConfig, *,
                 tokenizer_decode: Callable[[Sequence[int]], str],
                 tag_token_ids: Dict[str, Sequence[int]],
                 eos_token_ids: Sequence[int] = (),
                 engine_kwargs: Optional[dict] = None,
                 ref_model=None, mesh=None, critic=None,
                 banned_token_ids: Sequence[int] = (),
                 tokenizer_batch_decode: Optional[
                     Callable[[Sequence[Sequence[int]]], List[str]]] = None,
                 reward_manager: Optional[RewardManager] = None):
        alg = cfg.algorithm
        # dp: the ranks that split the batch; sp: the seq ranks that split
        # each row (actor.ulysses_size sizes the mesh's seq axis in
        # rl_main); tp: the model ranks that serve the rollout together
        # (rollout.tensor_parallel_size sizes the model axis)
        self.mesh = mesh
        self.dp = axis_size(mesh, *BATCH_AXES)
        self.sp = axis_size(mesh, SEQ)
        self.tp = axis_size(mesh, MODEL)
        if cfg.rollout.tensor_parallel_size > 1 and \
                self.tp != cfg.rollout.tensor_parallel_size:
            raise ValueError(
                f"rollout.tensor_parallel_size="
                f"{cfg.rollout.tensor_parallel_size} but the mesh model "
                f"axis is {self.tp} — size the mesh with "
                "MeshConfig(model=tensor_parallel_size)")
        if cfg.actor.ulysses_size > 1 and self.sp != cfg.actor.ulysses_size:
            raise ValueError(
                f"actor.ulysses_size={cfg.actor.ulysses_size} but the mesh "
                f"seq axis is {self.sp} — size the mesh with "
                "MeshConfig(seq=ulysses_size)")
        if mesh is not None and ref_model is not None and \
                cfg.actor.offload_ref_params:
            raise ValueError(
                "offload_ref_params is single-GPU: under a mesh the "
                "reference policy is FSDP-sharded instead")
        if (alg.adv_estimator == "gae") != (critic is not None):
            raise ValueError(
                "adv_estimator='gae' needs a critic (rl/critic.py "
                "CriticTrainer over models.qwen25_vl.QwenForValue), and a "
                f"critic is used only by 'gae' (adv_estimator="
                f"{alg.adv_estimator!r}, critic {critic is not None})")
        self.model = model
        self.critic = critic
        self.device = next(model.parameters()).device
        self.cfg = cfg
        self.kl_ctrl = None
        if ref_model is not None and not alg.use_kl_loss:
            if alg.adv_estimator == "router":
                raise ValueError(
                    "the reward-side KL penalty (use_kl_loss=False with "
                    "ref_model) is wired for grpo/rloo/"
                    "reinforce_plus_plus — the router estimator works on "
                    "per-channel scalar rewards; use use_kl_loss=True "
                    "(in-loss KL) with router instead")
            from .ppo import get_kl_controller
            self.kl_ctrl = get_kl_controller(alg.kl_type, alg.kl_coef,
                                             alg.kl_target, alg.kl_horizon)
        self.decode = tokenizer_decode
        # ONE host call decodes the whole rollout (HF batch_decode) instead
        # of bs×n serial per-sample decodes
        self.batch_decode = tokenizer_batch_decode if \
            tokenizer_batch_decode is not None else \
            (lambda seqs: [tokenizer_decode(s) for s in seqs])
        # pluggable rewards (reference FunctionRewardManager,
        # function.py:47-105): cfg.reward.reward_function importlib-loads a
        # user scorer; None = in-tree evidencecot. The manager owns the
        # channel list + token-span table consumed everywhere below.
        self.reward_manager = reward_manager if reward_manager is not None \
            else RewardManager(
                cfg.reward,
                max_response_length=cfg.rollout.max_response_length)
        self.channels = self.reward_manager.channels
        missing_tags = self.reward_manager.required_tags - set(tag_token_ids)
        if missing_tags:
            raise ValueError(
                f"tag_token_ids is missing encodings for span tags "
                f"{sorted(missing_tags)} required by the reward channels — "
                "encode them with the tokenizer (add_special_tokens=False)")
        self.tag_token_ids = tag_token_ids
        self.eos = tuple(eos_token_ids)
        # rollout sampling bans these ids via logit bias -100 — the
        # reference bans the image token in every rollout so responses can
        # never contain `<image>` (vllm_rollout_spmd.py:42-49,132)
        self.logit_bias = banned_ids_bias(banned_token_ids)
        self.engine_kwargs = dict(num_slots=8, max_len=4096,
                                  prompt_buckets=(512, 1024, 2048, 4096))
        self.engine_kwargs.update(engine_kwargs or {})
        self._engine: Optional[Engine] = None
        self._uid_next = 0
        # optional data.StatefulIterator over prompt batches: its cursor +
        # the fit loop's rng ride in checkpoints so resume consumes the
        # exact same batch sequence
        self.data_iter = None
        self._rng: Optional[torch.Generator] = None
        self._last_token_scores = None

        a = cfg.actor
        # the frozen tower takes no gradient and is left out of the
        # optimizer entirely
        self._frozen = None
        if a.freeze_vision_tower and getattr(model, "visual", None) \
                is not None:
            self._frozen = model.visual
            self._frozen.requires_grad_(False)
        self._offload = bool(a.offload_frozen_params) \
            and self._frozen is not None
        # the ref policy's tower is never consulted: ref log-probs consume
        # the vision_embeds table computed by the actor's identical frozen
        # tower — drop the copy
        self.ref_model = ref_model
        if ref_model is not None:
            ref_model.requires_grad_(False)
            if self._frozen is not None:
                ref_model.visual = None
        self._offload_ref = bool(a.offload_ref_params) \
            and ref_model is not None
        if self._offload_ref:
            ref_model.to("cpu")
        # under a mesh: the engine's whole copy of the actor (the frozen
        # tower shared), or at tp > 1 this rank's tensor-parallel shard of
        # it, on the ranks that roll out, refilled from the sharded weights
        # when they have changed (_stale)
        self._rollout_model = None
        self._stale = False
        self._group = None
        if mesh is not None:
            from ..mesh import shard_module_tp, sub_mesh
            from ..training.trainer import shard_model
            if axis_index(mesh, SEQ) == 0:
                self._rollout_model = shard_module_tp(model, mesh) \
                    if self.tp > 1 else self._whole_copy(model)
            weights = sub_mesh(mesh, *WEIGHT_AXES)
            shard_model(model, model.model.layers, mesh, weights,
                        ignored=self._frozen)
            if ref_model is not None:
                shard_model(ref_model, ref_model.model.layers, mesh, weights)
            self._group = axis_group(mesh, *WEIGHT_AXES)
        self.train_params = [p for p in model.parameters() if p.requires_grad]
        lr = constant_schedule_with_warmup(
            a.lr, resolve_warmup_steps(a.lr_warmup_steps, a.lr_warmup_ratio,
                                       cfg.trainer.total_steps))
        self.optimizer = adamw_from_config(
            self.train_params, lr, weight_decay=a.weight_decay,
            b1=a.betas[0], b2=a.betas[1],
            state_dtype=a.optimizer_state_dtype)
        self.step = 0

    # ---- device placement ---------------------------------------------

    def _put(self, x):
        return torch.as_tensor(np.asarray(x), device=self.device)

    def _put_batch(self, batch: Dict[str, np.ndarray]):
        return {k: ({kk: self._put(vv) for kk, vv in v.items()}
                    if isinstance(v, dict)
                    else v if isinstance(v, torch.Tensor) else self._put(v))
                for k, v in batch.items()}

    # ---- the rollout copy (under a mesh) --------------------------------

    def _whole_copy(self, model):
        """A copy of the actor for the engine, with its own text weights
        and the frozen tower shared (it never changes)."""
        import copy
        tower = self._frozen
        if tower is not None:
            model.visual = None
        try:
            whole = copy.deepcopy(model).requires_grad_(False)
        finally:
            if tower is not None:
                model.visual = tower
        if tower is not None:
            whole.visual = tower
        return whole

    def _refill_rollout(self):
        """The handoff after an update (the JAX Engine.set_params): every
        rank gathers the actor's sharded weights, one tensor at a time and
        in one order; the ranks that roll out copy them into their whole
        copy, or their slices into their tensor-parallel shard."""
        from ..mesh import load_tp_shard
        load_tp_shard(self._rollout_model, self.model,
                      skip=("visual.",) if self._frozen is not None else ())
        self._stale = False

    # ---- model passes --------------------------------------------------

    @property
    def _sp_mesh(self):
        return self.mesh if self.sp > 1 else None

    @staticmethod
    def _vision_kwargs(batch):
        return {k: batch[k] for k in ("vision_batch", "slot_map",
                                      "vision_embeds") if k in batch}

    @torch.no_grad()
    def _logp_fn(self, model, batch):
        _, hidden = model(batch["input_ids"],
                          attention_mask=batch["attention_mask"],
                          positions=batch["positions"], return_logits=False,
                          sp_mesh=self._sp_mesh,
                          **self._vision_kwargs(batch))
        # the chunked head: the (B, S, V) logits never exist
        logp = next_token_log_probs(model.compute_logits, hidden,
                                    batch["input_ids"], self._sp_mesh)
        # logp[t] = log p(token at t+1 | ...); response_mask marks generated
        # tokens, so shift: contribution of token t is at position t-1
        shifted = torch.roll(batch["response_mask"], -1, dims=1)
        return logp * seq_block(shifted, self._sp_mesh)

    def _ppo_terms(self, logp, batch, total_tokens):
        """Shared PPO objective; masks in batch are already logp-aligned.
        Under a mesh: this rank's share over its rows and sequence block."""
        sp = self._sp_mesh
        adv = batch["advantages"]
        return ppo_loss(
            seq_block(batch["old_log_probs"], sp), logp,
            seq_block(adv, sp, 2) if adv.dim() == 3 else adv,
            seq_block(batch["response_mask"], sp),
            seq_block(batch["reward_masks"], sp, 2),
            ref_log_probs=(seq_block(batch["ref_log_probs"], sp)
                           if "ref_log_probs" in batch else None),
            kl_coef=self.cfg.actor.kl_coef, kl_type=self.cfg.actor.kl_type,
            clip_ratio_low=self.cfg.actor.clip_ratio_low,
            clip_ratio_high=self.cfg.actor.clip_ratio_high,
            clip_ratio_dual=self.cfg.actor.clip_ratio_dual,
            total_tokens=total_tokens, group=self._group)

    def micro_loss(self, batch, total_tokens, packed: bool):
        """Loss and metrics of one micro-batch (tensors on the device).
        packed: rows hold several sequences kept apart by `segment_ids`
        (the segment kernel); else right-padded rows with `attention_mask`
        (the valid-length kernel). Masks (logp-aligned) zero out
        cross-segment label positions. Under a mesh the loss is this
        rank's share and the metrics the micro-batch's."""
        if packed:
            kw = dict(segment_ids=batch["segment_ids"],
                      **{k: batch[k] for k in ("vision_embeds", "slot_map")
                         if k in batch})
        else:
            kw = dict(attention_mask=batch["attention_mask"],
                      **self._vision_kwargs(batch))
        _, hidden = self.model(batch["input_ids"],
                               positions=batch["positions"],
                               return_logits=False, sp_mesh=self._sp_mesh,
                               **kw)
        logp = next_token_log_probs(self.model.compute_logits, hidden,
                                    batch["input_ids"], self._sp_mesh)
        logp = logp * seq_block(batch["response_mask"], self._sp_mesh)
        return self._ppo_terms(logp, batch, total_tokens)

    def _grad(self, batch, total_tokens, packed: bool):
        """One micro-batch's backward; gradients add into `.grad`. Under a
        mesh the share's backward is scaled by the rank count (FSDP2
        averages the ranks' gradients) and the micro-batch's loss is
        returned."""
        loss, metrics = self.micro_loss(batch, total_tokens, packed)
        if self.mesh is None:
            loss.backward()
        else:
            (loss * axis_size(self.mesh, *WEIGHT_AXES)).backward()
        return group_sum(loss.detach(), self._group), \
            {k: v.detach() for k, v in metrics.items()}

    def _apply(self) -> Dict[str, torch.Tensor]:
        """Clip and step. A non-finite gradient norm (reference
        dp_actor.py:163-169) skips the optimizer entirely: parameters, the
        moments, the step count and the Kahan compensation all stay as they
        were."""
        gnorm = clip_by_global_norm_(self.train_params,
                                     self.cfg.actor.grad_clip)
        ok = bool(torch.isfinite(gnorm))
        if ok:
            self.optimizer.step()
        for p in self.train_params:
            p.grad = None
        return {"grad_norm": gnorm, "grad_skipped": 0.0 if ok else 1.0}

    # ---- rollout → batch ------------------------------------------------

    def rollout(self, prompts: List[dict], seed: int, *,
                n: Optional[int] = None,
                temperature: Optional[float] = None) -> RolloutBatch:
        """prompts: dicts with input_ids (+positions, vision_batch, slot_map,
        ground_truth). Each prompt sampled cfg.rollout.n times (n/temperature
        overridable — the validation loop's val_override_config role). The
        engine is built once and reused across steps; `seed` reseeds its
        generator for this rollout. Under a mesh the prompts are shared out
        over (replica, data) and every rank gets the whole batch
        (_generate)."""
        n = n if n is not None else self.cfg.rollout.n
        if self._offload:
            self._frozen.to(self.device)   # prefill embeds need the tower
        sampling = SamplingParams(
            temperature=(temperature if temperature is not None
                         else self.cfg.rollout.temperature),
            top_p=self.cfg.rollout.top_p,
            max_tokens=self.cfg.rollout.max_response_length,
            logit_bias=self.logit_bias)
        # combine per-prompt vision tables into one batch table so the
        # update path runs the (frozen) vision tower once
        vision = None
        slot_offset = {}
        vis_tables = [p["vision_batch"] for p in prompts
                      if p.get("vision_batch") is not None]
        if vis_tables:
            from ..preprocess.qwen_vision import combine_vision_batches
            vision, offs = combine_vision_batches(vis_tables)
            it = iter(offs)
            for pi, p in enumerate(prompts):
                if p.get("vision_batch") is not None:
                    slot_offset[pi] = next(it)
        expanded = []
        uids = []
        gts = []
        prompt_idx = []
        for pi, p in enumerate(prompts):
            uid = self._uid_next
            self._uid_next += 1
            for _ in range(n):
                expanded.append({k: v for k, v in p.items()
                                 if k != "ground_truth"})
                uids.append(uid)
                gts.append(p.get("ground_truth", ""))
                prompt_idx.append(pi)
        # ONE prefill per prompt group; the n samples fork the prompt KV
        # blocks (outputs come back n-consecutive per prompt, matching
        # `expanded`'s layout)
        outs = self._generate(
            [{k: v for k, v in p.items() if k != "ground_truth"}
             for p in prompts], seed, sampling, n)

        max_len = max(len(p["input_ids"]) + len(o)
                      for p, o in zip(expanded, outs))
        max_len = -(-max_len // 128) * 128
        bs = len(expanded)
        input_ids = np.zeros((bs, max_len), np.int32)
        mask = np.zeros((bs, max_len), np.int32)
        rmask = np.zeros((bs, max_len), np.int32)
        positions = np.zeros((3, bs, max_len), np.int32)
        slot_map = np.full((bs, max_len), -1, np.int32) if vision else None
        texts = self.batch_decode(outs)
        for i, (p, o) in enumerate(zip(expanded, outs)):
            pl = len(p["input_ids"])
            full = np.concatenate([p["input_ids"], np.asarray(o, np.int32)])
            input_ids[i, :len(full)] = full
            mask[i, :len(full)] = 1
            rmask[i, pl:len(full)] = 1
            ppos = p.get("positions")
            if ppos is None:
                ppos = np.broadcast_to(np.arange(pl), (3, pl))
            positions[:, i, :pl] = ppos
            base = int(np.max(ppos)) + 1
            positions[:, i, pl:len(full)] = base + np.arange(len(full) - pl)
            if vision is not None and p.get("slot_map") is not None:
                sl = np.asarray(p["slot_map"], np.int32)
                off = slot_offset[prompt_idx[i]]
                slot_map[i, :pl] = np.where(sl >= 0, sl + off, -1)
        return RolloutBatch(input_ids=input_ids, attention_mask=mask,
                            positions=positions, response_mask=rmask,
                            responses=outs, response_texts=texts,
                            uid=np.asarray(uids), ground_truths=gts,
                            vision=vision, slot_map=slot_map)

    def _generate(self, prompts: List[dict], seed: int,
                  sampling: SamplingParams, n: int) -> List[List[int]]:
        """The engine's n samples of each prompt, n-consecutive in prompt
        order. Under a mesh, rank i of (replica, data) generates its
        contiguous share of the prompts on its whole copy of the actor, or
        with its model group on their shards (refilled first if the
        weights changed; every rank enters that gather), the seq ranks
        after the first generate nothing, and the shares are gathered in
        rank order."""
        model = self.model
        if self.mesh is not None:
            if self._stale:
                self._refill_rollout()
            model = self._rollout_model
            i, k = axis_index(self.mesh, *BATCH_AXES), self.dp
            prompts = prompts[i * len(prompts) // k:
                              (i + 1) * len(prompts) // k] \
                if model is not None else []
            seed = _rank_seed(seed, i)
        outs = []
        if model is not None:
            if self._engine is None:
                self._engine = Engine(
                    model, eos_token_ids=self.eos,
                    mesh=self.mesh if self.tp > 1 else None,
                    **self.engine_kwargs)
            else:
                # the weights changed (updated in place, or refilled); the
                # cached prefix KV was computed with the old ones
                self._engine.set_params(model)
            self._engine.generator.manual_seed(int(seed))
            if prompts:
                outs = self._engine.generate(prompts, sampling=sampling, n=n)
            # the vLLM sleep role: the KV pools' memory belongs to the
            # update step between rollouts; run() re-wakes
            self._engine.sleep()
        if self.mesh is None:
            return outs
        import torch.distributed as dist
        shares = [None] * dist.get_world_size(self._group)
        dist.all_gather_object(shares, outs, group=self._group)
        return [o for share in shares for o in share]

    def make_batch(self, prompt_iter: Iterator[List[dict]],
                   rng: torch.Generator, timers=None) -> Optional[dict]:
        """Rollout + rewards + advantage with online filtering that pulls
        FRESH prompt groups per retry (ray_trainer._make_batch_data :467-558:
        each try draws a new dataloader batch; uids are unique across tries).
        prompt_iter yields lists of prompt dicts; exhausting it returns what
        was collected (None if nothing) — pass itertools.cycle(...) for the
        reference's restart-on-StopIteration behavior. timers: optional
        utils.tracker.Timers splitting gen / reward / host_assemble."""
        if timers is None:
            from ..utils.tracker import Timers
            timers = Timers()
        alg = self.cfg.algorithm
        n = self.cfg.rollout.n
        target_rows = self.cfg.trainer.rollout_batch_size * n
        collected: List[dict] = []
        tries = 0
        while True:
            tries += 1
            try:
                prompts = next(prompt_iter)
            except StopIteration:
                break
            with timers("gen"):
                rb = self.rollout(prompts, _draw_seed(rng))
            with timers("reward"):
                reward_tensor, _metrics = self.reward_manager.compute(
                    rb.response_texts, rb.ground_truths,
                    [len(r) for r in rb.responses])
            baselines = None
            if alg.adv_estimator == "remax":
                # ReMax greedy baseline (ray_trainer.py:497-509): one extra
                # temperature=0, n=1 rollout per prompt batch, scored with
                # the same reward fn; each prompt's n samples share its
                # greedy score as the advantage baseline
                with timers("gen"):
                    grb = self.rollout(prompts, _draw_seed(rng), n=1,
                                       temperature=0.0)
                with timers("reward"):
                    g_rewards, _ = self.reward_manager.compute(
                        grb.response_texts, grb.ground_truths,
                        [len(r) for r in grb.responses])
                baselines = np.repeat(g_rewards.sum(-1), n)
            keep_uids = set(rb.uid.tolist())
            if alg.online_filtering:
                if alg.filter_key not in self.channels:
                    raise ValueError(
                        f"algorithm.filter_key={alg.filter_key!r} is not a "
                        f"reward channel (have {list(self.channels)})")
                ch = self.channels.index(alg.filter_key)
                keep_uids = set()
                for uid in np.unique(rb.uid):
                    sel = rb.uid == uid
                    m = reward_tensor[sel, ch].mean()
                    if alg.filter_low < m < alg.filter_high:
                        keep_uids.add(int(uid))
            with timers("host_assemble"):
                part = self._finalize(rb, reward_tensor, keep_uids,
                                      baselines=baselines)
            if part is not None:
                collected.append(part)
            total = sum(c["input_ids"].shape[0] for c in collected)
            if total >= target_rows or not alg.online_filtering \
                    or tries >= alg.max_try_make_batch:
                break
        if not collected:
            return None
        # pad every part to the max sequence length before concatenating
        S = max(p["input_ids"].shape[1] for p in collected)

        def pad_part(p):
            out = {}
            for k, v in p.items():
                if k in ("input_ids", "attention_mask", "response_mask"):
                    out[k] = np.pad(v, ((0, 0), (0, S - v.shape[1])))
                elif k == "slot_map":
                    out[k] = np.pad(v, ((0, 0), (0, S - v.shape[1])),
                                    constant_values=-1)
                elif k in ("positions", "reward_masks"):
                    out[k] = np.pad(v, ((0, 0), (0, 0), (0, S - v.shape[-1])))
                else:
                    out[k] = v
            return out

        with timers("host_assemble"):
            parts = [pad_part(p) for p in collected]
            # merge per-try vision tables, re-offsetting each part's slot map
            tables = [p.pop("_vision", None) for p in parts]
            vision = None
            if any(t is not None for t in tables):
                from ..preprocess.qwen_vision import combine_vision_batches
                vis_list = [t for t in tables if t is not None]
                vision, offs = combine_vision_batches(vis_list)
                it = iter(offs)
                for p, t in zip(parts, tables):
                    if t is None:
                        p["slot_map"] = np.full_like(p["input_ids"], -1)
                    else:
                        off = next(it)
                        p["slot_map"] = np.where(p["slot_map"] >= 0,
                                                 p["slot_map"] + off, -1)
            batch = {k: np.concatenate([p[k] for p in parts],
                                       axis=1 if k == "positions" else 0)
                     for k in parts[0]}
            if vision is not None:
                batch["vision_batch"] = vision
        # keep whole uid groups: every part contributes multiples of n rows
        return _reindex(batch, slice(0, target_rows)) \
            if batch["input_ids"].shape[0] > target_rows else batch

    def _finalize(self, rb: RolloutBatch, reward_tensor, keep_uids,
                  baselines=None):
        keep = np.asarray([u in keep_uids for u in rb.uid])
        if not keep.any():
            return None
        sel = np.nonzero(keep)[0]
        max_resp = max(len(rb.responses[i]) for i in sel)
        resp_arr = np.zeros((len(sel), max_resp), np.int32)
        resp_m = np.zeros((len(sel), max_resp), np.int32)
        for j, i in enumerate(sel):
            r = rb.responses[i]
            resp_arr[j, :len(r)] = r
            resp_m[j, :len(r)] = 1
        reward_masks_resp = build_reward_masks(
            resp_arr, resp_m, self.tag_token_ids,
            channels=self.channels, spans=self.reward_manager.spans)
        # lift response-relative masks onto the full sequence layout
        bs, S = rb.input_ids[sel].shape
        reward_masks = np.zeros((bs, len(self.channels), S), np.int32)
        for j, i in enumerate(sel):
            pl = int(np.sum(rb.attention_mask[i]) -
                     np.sum(rb.response_mask[i]))
            nr = int(resp_m[j].sum())
            reward_masks[j, :, pl:pl + nr] = reward_masks_resp[j, :, :nr]

        if self.cfg.algorithm.adv_estimator == "router":
            adv, _ = compute_advantage(
                "router", reward_tensor=reward_tensor[sel],
                index=rb.uid[sel],
                norm_by_std=self.cfg.algorithm.norm_adv_by_std)
        else:
            # the token-level estimators (grpo/rloo/r++/remax) compute over
            # the FULL assembled batch in fit() — batch whitening and the
            # reward-side KL penalty need the whole batch, not one
            # filtering part
            adv = np.zeros((bs, len(self.channels)), np.float32)
        part = dict(input_ids=rb.input_ids[sel],
                    attention_mask=rb.attention_mask[sel],
                    positions=rb.positions[:, sel],
                    response_mask=rb.response_mask[sel],
                    reward_masks=reward_masks,
                    reward_tensor=reward_tensor[sel],
                    advantages=adv, uid=rb.uid[sel])
        if baselines is not None:
            part["reward_baselines"] = \
                np.asarray(baselines, np.float32)[sel]
        if rb.vision is not None:
            part["slot_map"] = rb.slot_map[sel]
            part["_vision"] = rb.vision
        return part

    # ---- log-prob inference (micro-batched) ------------------------------

    def compute_log_probs(self, model, batch: Dict[str, np.ndarray]
                          ) -> np.ndarray:
        """(bs, S) log-probs of `model` (the actor or the reference policy)
        at shifted positions, micro-batched under the actor token budget
        (dp_actor.compute_log_probs role). Right-padded rows: the
        valid-length kernel, no gradient. Under a mesh every rank computes
        its part of each micro-batch and every rank gets the whole."""
        bs, S = batch["input_ids"].shape
        seqlens = batch["attention_mask"].sum(1)
        groups, _ = token_budget_micro_batches(
            seqlens, max(self.cfg.actor.micro_batch_tokens, int(S)))
        out = np.zeros((bs, S), np.float32)
        keys = [k for k in ("input_ids", "attention_mask", "positions",
                            "response_mask", "slot_map", "vision_embeds")
                if k in batch]
        for g in groups:
            micro = self._rank_micro({k: batch[k] for k in keys}, g)
            lp = self._logp_fn(model, self._put_batch(micro))
            if self.mesh is not None:
                lp = gather_parts(lp, self.mesh, self.sp)[:len(g), :S]
            out[list(g)] = lp.float().cpu().numpy()
        return out

    def _rank_micro(self, mini: Dict[str, np.ndarray], g: Sequence[int],
                    zero_pad: bool = False) -> Dict[str, np.ndarray]:
        """The padded micro-batch of rows g; under a mesh this rank's part
        (rank_part), the rows first padded to a multiple of dp with copies
        of row g[0] (an all-pad row would have no key to attend), whose
        masks zero_pad zeroes."""
        if self.mesh is None:
            return _reindex(mini, list(g))
        idx = list(g) + [g[0]] * (-len(g) % self.dp)
        micro = _reindex(mini, idx)
        if zero_pad:
            for k in ("response_mask", "reward_masks"):
                micro[k] = micro[k].copy()
                micro[k][len(g):] = 0
        return rank_part(micro, self.mesh, BATCH_AXES, seq=True)

    # ---- policy update ---------------------------------------------------

    def _pack_micro(self, mini: Dict[str, np.ndarray], g: Sequence[int],
                    seqlens, width: int) -> Dict[str, torch.Tensor]:
        """Build the packed (padding-free) micro-batch: trim each sequence to
        its true length and pack with segment ids (first-fit, so the ids in
        a row are not ascending; 0 pads the tail). Under a mesh the rows
        of the whole group are packed, and this rank takes its part."""
        nch = len(self.channels)
        seqs, extra = [], defaultdict(list)
        for i in g:
            L = int(seqlens[i])
            seqs.append(mini["input_ids"][i, :L])
            extra["response_mask"].append(mini["response_mask"][i, :L])
            extra["old_log_probs"].append(mini["old_log_probs"][i, :L])
            if "ref_log_probs" in mini:
                extra["ref_log_probs"].append(mini["ref_log_probs"][i, :L])
            if "slot_map" in mini:
                # +1 so the packer's zero-fill decodes as -1 (text position)
                extra["slot_map"].append(mini["slot_map"][i, :L] + 1)
            for a in range(3):
                extra[f"pos{a}"].append(mini["positions"][a, i, :L])
            for c in range(nch):
                rm = mini["reward_masks"][i, c, :L]
                extra[f"rm{c}"].append(rm)
                extra[f"adv{c}"].append(
                    (mini["advantages"][i, c] * rm).astype(np.float32))
        packed, ex = pack_sequences(seqs, width, extra=dict(extra))
        batch = {
            "input_ids": packed.input_ids,
            "segment_ids": packed.segment_ids,
            "positions": np.stack([ex[f"pos{a}"] for a in range(3)]),
            "response_mask": ex["response_mask"],
            "old_log_probs": ex["old_log_probs"],
            "reward_masks": np.stack([ex[f"rm{c}"] for c in range(nch)],
                                     axis=1),
            "advantages": np.stack([ex[f"adv{c}"] for c in range(nch)],
                                   axis=1),
        }
        if "ref_log_probs" in ex:
            batch["ref_log_probs"] = ex["ref_log_probs"]
        if "slot_map" in ex:
            batch["slot_map"] = ex["slot_map"] - 1
            batch["vision_embeds"] = mini["vision_embeds"]
        if self.mesh is not None:
            # pad rows: segment id 0 and masks 0 (they count nothing)
            batch = rank_part(batch, self.mesh, BATCH_AXES, seq=True)
        return self._put_batch(batch)

    def update_policy(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        """Minibatch/micro-batch PPO update (dp_actor.update_policy
        :219-302).

        Expects logp-space keys: old_log_probs (+ ref_log_probs) from
        compute_log_probs. Shifts response/reward masks into logp space here.
        The packed branch runs the segment kernels forward and backward; the
        padded branch (padding_free=False, or a raw vision_batch in the
        batch) runs the valid-length kernels (K1 with the LSE forward, K2
        backward, at d = 128 with grouped kv heads).
        """
        cfg = self.cfg
        if self._offload:
            self._frozen.to("cpu")   # idempotent; fit() already did it
        batch = dict(batch)
        # shift masks into logp space: position t ↔ generated token t+1.
        # (np.roll wraparound is harmless: position 0 is always a prompt
        # token, so mask[..., 0] == 0.)
        batch["response_mask"] = np.roll(batch["response_mask"], -1, axis=1)
        batch["reward_masks"] = np.roll(batch["reward_masks"], -1, axis=2)
        if batch["advantages"].ndim == 3:   # per-token → logp space too
            batch["advantages"] = np.roll(batch["advantages"], -1, axis=2)

        bs, S = batch["input_ids"].shape
        seqlens = batch["attention_mask"].sum(1)
        if self.dp > 1 and bs % self.dp == 0:
            # balance the dp ranks' token counts (ray_trainer._balance_batch)
            perm = reorder_for_dp(seqlens, self.dp)
            batch = _reindex(batch, perm)
            seqlens = seqlens[perm]
        # packed path supports precomputed vision embeds (slot maps pack like
        # any per-token channel); raw vision_batch must go padded
        packed_ok = (cfg.actor.padding_free and "vision_batch" not in batch
                     and batch["advantages"].ndim == 2)
        mini_size = min(cfg.trainer.global_batch_size, bs)
        agg = defaultdict(list)
        for _ in range(cfg.actor.ppo_epochs):
            for lo in range(0, bs, mini_size):
                idx = np.arange(lo, min(lo + mini_size, bs))
                mini = _reindex(batch, idx)
                mlens = seqlens[idx]
                # the minibatch's per-channel token totals (the reference's
                # all-reduced total_response_tokens, dp_actor.py:237-238:
                # global, the minibatch being the global one)
                total = self._put(mini["reward_masks"]
                                  .sum((0, 2)).astype(np.float32))
                groups, _ = token_budget_micro_batches(
                    mlens, max(cfg.actor.micro_batch_tokens, int(S)))
                for p in self.train_params:
                    p.grad = None
                for g in groups:
                    if packed_ok:
                        micro = self._pack_micro(mini, g, mlens, S)
                    else:
                        micro = self._put_batch(
                            self._rank_micro(mini, g, zero_pad=True))
                    loss, m = self._grad(micro, total, packed_ok)
                    agg["loss"].append(loss)
                    for k, v in m.items():
                        agg[k].append(v)
                for k, v in self._apply().items():
                    agg[k].append(v)
        self._stale = self.mesh is not None
        return {k: float(np.mean([float(x) for x in v]))
                for k, v in agg.items()}

    def _scored_tokens(self, batch) -> Tuple[np.ndarray, Dict[str, float]]:
        """(bs, S) token-space scores: the scalar reward at the last
        response token (sequential reward manager role, reward/function.py:
        80-105), plus the optional reward-side KL penalty
        (ray_trainer.py:110-127 — applied for ALL estimators that consume
        token rewards)."""
        bs, S = batch["input_ids"].shape
        tok_scores = np.zeros((bs, S), np.float32)
        last = batch["attention_mask"].sum(1) - 1
        tok_scores[np.arange(bs), last] = batch["reward_tensor"].sum(-1)
        metrics = {}
        if self.kl_ctrl is not None and "ref_log_probs" in batch:
            from .ppo import apply_kl_penalty
            old_tok = np.roll(batch["old_log_probs"], 1, axis=1)
            ref_tok = np.roll(batch["ref_log_probs"], 1, axis=1)
            tok_scores, metrics = apply_kl_penalty(
                tok_scores, old_tok, ref_tok, batch["response_mask"],
                self.kl_ctrl, self.cfg.algorithm.kl_penalty)
        # post-KL token rewards feed the critic/rewards metric family
        # (the reference's token_level_rewards, metrics.py:50)
        self._last_token_scores = tok_scores
        return tok_scores, metrics

    def _prepare_gae(self, batch: Dict[str, np.ndarray],
                     timers=None) -> Dict[str, float]:
        """GAE advantages and returns from the critic's values, with the
        optional reward-side KL penalty (ray_trainer.py:110-127, :622-649).

        Space bookkeeping: critic values and log-probs live at position t
        for token t+1 (logp space); GAE runs at token positions, so values
        and KL roll +1 into token space and advantages/returns roll -1
        back."""
        alg = self.cfg.algorithm
        if timers is None:
            from ..utils.tracker import Timers
            timers = Timers()
        with timers("values"):
            values = self.critic.compute_values(batch)  # (bs, S), logp
        batch["values"] = values
        tok_scores, metrics = self._scored_tokens(batch)
        values_tok = np.roll(values, 1, axis=1) * batch["response_mask"]
        adv_tok, ret_tok = compute_advantage(
            "gae", token_rewards=tok_scores, values=values_tok,
            response_mask=batch["response_mask"], gamma=alg.gamma,
            lam=alg.lam)
        batch["advantages"] = adv_tok[:, None, :]
        batch["reward_masks"] = \
            batch["response_mask"][:, None, :].astype(np.int32)
        batch["returns"] = np.roll(ret_tok, -1, axis=1)   # logp space
        return metrics

    def _prepare_token_adv(self, batch: Dict[str, np.ndarray]
                           ) -> Dict[str, float]:
        """Per-token advantages for grpo/rloo/reinforce_plus_plus/remax over
        the FULL assembled batch (group stats / batch whitening need every
        row; ray_trainer.compute_advantage :130-159). Stored (bs, 1, S);
        reward_masks collapse to the response mask. remax consumes the
        greedy-rollout baselines make_batch collected (reference
        reward_baselines, ray_trainer.py:497-509)."""
        alg = self.cfg.algorithm
        tok_scores, metrics = self._scored_tokens(batch)
        adv_tok, _ = compute_advantage(
            alg.adv_estimator, token_rewards=tok_scores,
            response_mask=batch["response_mask"], index=batch["uid"],
            greedy_scores=batch.get("reward_baselines"),
            gamma=alg.gamma, norm_by_std=alg.norm_adv_by_std)
        batch["advantages"] = adv_tok[:, None, :]
        batch["reward_masks"] = \
            batch["response_mask"][:, None, :].astype(np.int32)
        return metrics

    # ---- validation / checkpointing ---------------------------------------

    def validate(self, prompts: List[dict], seed: int = 0, tracker=None
                 ) -> Dict[str, float]:
        """Validation rollout + reward scoring + deterministic gen-sample
        table (ray_trainer._validate :375-448 and
        _maybe_log_val_generations :375-391). Under a mesh the rollout is
        split and gathered as a step's is."""
        t = self.cfg.trainer
        rb = self.rollout(prompts, seed, n=t.val_n,
                          temperature=t.val_temperature)
        reward_tensor, reward_metrics = self.reward_manager.compute(
            rb.response_texts, rb.ground_truths,
            [len(r) for r in rb.responses])
        scores = reward_tensor.sum(-1)
        if tracker is not None and t.val_generations_to_log > 0:
            inputs = [self.decode(list(p["input_ids"])) for p in prompts
                      for _ in range(t.val_n)]
            samples = sorted(zip(inputs, rb.response_texts,
                                 rb.ground_truths, scores.tolist()),
                             key=lambda x: x[0])
            np.random.RandomState(42).shuffle(samples)
            tracker.log_generations(self.step, [
                dict(input=i, output=o, label=l, score=s)
                for i, o, l, s in samples[:t.val_generations_to_log]])
        out = {"val/reward_score": float(scores.mean()),
               "val/response_length": float(np.mean(
                   [len(r) for r in rb.responses]))}
        out.update({f"val/{k}_reward": float(np.mean(v))
                    for k, v in reward_metrics.items()})
        return out

    def save(self, best_metric: Optional[float] = None) -> str:
        """Checkpoint the actor's (and the critic's) weights and optimizer
        state + host counters (step, uid counter, KL coefficient, data
        cursor, the rng's state) with tracker manifest and keep-best GC
        (ray_trainer._save_checkpoint :312-344). Under a mesh every rank
        calls it and rank 0 writes the full tensors."""
        from ..training.checkpoint import (_ckpt_dir, full_tensors,
                                           save_checkpoint)
        tree = {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}
        if self.critic is not None:
            tree["critic_model"] = self.critic.model.state_dict()
            tree["critic_optimizer"] = self.critic.optimizer.state_dict()
        extra = {"step": self.step, "uid_next": self._uid_next,
                 "kl_coef": (self.kl_ctrl.kl_coef if self.kl_ctrl else None)}
        if self.data_iter is not None:
            extra["data"] = self.data_iter.state()
        if self._rng is not None:
            extra["rng"] = self._rng.get_state().tolist()
        kw = dict(extra=extra, best_metric=best_metric,
                  save_limit=self.cfg.trainer.save_limit)
        out = self.cfg.trainer.output_dir
        if self.mesh is None:
            return save_checkpoint(out, self.step, tree, **kw)
        # every rank gathers the full tensors; rank 0 writes them
        import torch.distributed as dist
        tree = full_tensors(tree)
        if dist.get_rank() == 0:
            save_checkpoint(out, self.step, tree, **kw)
        dist.barrier()
        return _ckpt_dir(out, self.step)

    def maybe_resume(self) -> bool:
        """Auto-resume from the newest checkpoint under output_dir
        (ray_trainer._load_checkpoint :346-373 with find_last_checkpoint);
        under a mesh every rank loads it, whatever rank count wrote it."""
        from ..training.checkpoint import (find_latest_ckpt, load_checkpoint,
                                           load_state_into)
        path = find_latest_ckpt(self.cfg.trainer.output_dir)
        if path is None:
            return False
        tree, extra = load_checkpoint(path)
        # a sharded tensor takes its piece of the full one
        load_state_into(self.model, tree["model"])
        self.optimizer.load_state_dict(tree["optimizer"])
        if self.critic is not None:
            load_state_into(self.critic.model, tree["critic_model"])
            self.critic.optimizer.load_state_dict(tree["critic_optimizer"])
        self._stale = self.mesh is not None
        self.step = int(extra["step"])
        self._uid_next = int(extra["uid_next"])
        if self.kl_ctrl is not None and extra.get("kl_coef") is not None:
            self.kl_ctrl.kl_coef = extra["kl_coef"]
        if self.data_iter is not None and extra.get("data") is not None:
            self.data_iter.set_state(extra["data"])
        if extra.get("rng") is not None:
            self._rng = torch.Generator()
            self._rng.set_state(torch.tensor(extra["rng"], dtype=torch.uint8))
        return True

    # ---- outer loop ------------------------------------------------------

    def fit(self, prompt_iter: Iterable[List[dict]],
            rng: Optional[torch.Generator] = None,
            logger: Optional[Callable[[int, dict], None]] = None,
            val_prompts: Optional[List[dict]] = None, tracker=None):
        """prompt_iter yields lists of prompt dicts (one rollout batch per
        step; with online filtering each step may consume several). A
        checkpoint-resumed run continues with the saved rng (and, when
        self.data_iter is the prompt iterator, the saved data cursor)."""
        if rng is None:
            rng = self._rng if self._rng is not None \
                else torch.Generator().manual_seed(0)
        it = iter(prompt_iter)
        history = []
        self._val_score: Optional[float] = None
        from ..utils.tracker import Timers
        from .metrics import (compute_data_metrics, compute_timing_metrics,
                              compute_throughput_metrics)
        while True:
            t0 = time.time()
            timers = Timers()
            self._last_token_scores = None
            batch = self.make_batch(it, rng, timers=timers)
            if batch is None:
                break
            if "vision_batch" in batch:
                # frozen tower ⇒ encode all images ONCE per step into a flat
                # embedding table consumed by logp/update via slot maps
                # (replaces the reference's per-micro multi_modal_inputs +
                # uid cache, fsdp_workers.py:444-486)
                assert self.cfg.actor.freeze_vision_tower, (
                    "vision RL update requires freeze_vision_tower=True "
                    "(precomputed embeds carry no gradient)")
                from ..preprocess.qwen_vision import pad_vision_table
                vb = pad_vision_table(batch.pop("vision_batch"), 4096)
                with timers("vision_embed"), torch.no_grad():
                    batch["vision_embeds"] = self.model.encode_images(
                        {k: self._put(v) for k, v in vb.items()})
            if self._offload:
                # tower's last use this step was vision_embed — free its
                # memory for the logp/update passes (rollout() restores)
                self._frozen.to("cpu")
            # old log probs under the current (pre-update) policy
            with timers("old"):
                batch["old_log_probs"] = self.compute_log_probs(self.model,
                                                                batch)
            if self.ref_model is not None and \
                    (self.cfg.actor.kl_coef > 0 or self.kl_ctrl is not None):
                with timers("ref"):
                    # offloaded ref: on the device for this phase only
                    if self._offload_ref:
                        self.ref_model.to(self.device)
                    batch["ref_log_probs"] = self.compute_log_probs(
                        self.ref_model, batch)
                    if self._offload_ref:
                        self.ref_model.to("cpu")
            extra_metrics = {}
            with timers("adv"):
                if self.cfg.algorithm.adv_estimator == "gae":
                    extra_metrics = self._prepare_gae(batch, timers=timers)
                elif self.cfg.algorithm.adv_estimator != "router":
                    extra_metrics = self._prepare_token_adv(batch)
            # critic_warmup: the first steps train only the critic
            if self.step >= self.cfg.trainer.critic_warmup:
                with timers("update_actor"):
                    m = self.update_policy(batch)
            else:
                m = {}
            if self.critic is not None:
                with timers("update_critic"):
                    m.update(self.critic.update(batch))
            m.update(extra_metrics)
            self.step += 1
            m["reward_mean"] = float(batch["reward_tensor"].sum(-1).mean())
            m["step_time_s"] = time.time() - t0
            # the reference's per-step metric families (trainer/metrics.py:
            # 27-123): critic/* stats, length stats + clip ratios,
            # timing_s/* + timing_per_token_ms/*, perf/throughput
            timing_raw = dict(timers.times)
            timing_raw["step"] = m["step_time_s"]
            num_resp = int(batch["response_mask"].sum())
            num_all = int(batch["attention_mask"].sum())
            m.update(compute_data_metrics(
                batch, self.cfg.rollout.max_prompt_length,
                self.cfg.rollout.max_response_length,
                token_rewards=self._last_token_scores))
            m.update(compute_timing_metrics(timing_raw, num_resp, num_all))
            m.update(compute_throughput_metrics(
                num_all, timing_raw["step"],
                1 if self.mesh is None else self.mesh.size()))
            t = self.cfg.trainer
            if val_prompts is not None and t.val_freq > 0 and \
                    self.step % t.val_freq == 0:
                vm = self.validate(val_prompts, _draw_seed(rng),
                                   tracker=tracker)
                self._val_score = vm["val/reward_score"]
                m.update(vm)
            if t.save_freq > 0 and self.step % t.save_freq == 0:
                # stash the NEXT iteration's rng: a resumed run then draws
                # the same randomness an uninterrupted run would
                self._rng = rng
                self.save(best_metric=self._val_score)
            history.append((self.step, m))
            if logger:
                logger(self.step, m)
            if 0 < self.cfg.trainer.total_steps <= self.step:
                break
        return history
