"""RS-GRPO training driver.

Counterpart of visrag_tpu/driver/rl_main.py (CLI parity with the
reference's verl/trainer/main.py + run_rsgrpo.sh): YAML + dotlist merge into
the typed RLConfig tree; the whole loop is rl.trainer.RLTrainer.

    python -m visrag_tpu_torch.driver.rl_main --config rl.yaml \
        --data prompts.jsonl --checkpoint qwen_ckpt --output-dir out/ \
        --set rollout.n=8 --set actor.lr=1e-6 [--device cuda]

`--checkpoint` is an HF Qwen2.5-VL directory (safetensors, config.json, the
tokenizer and, for a released model, its processor). `build_trainer` and
`run_training` are what `main` runs, so that a caller with its own
tokenizer and weights can drive exactly the same path. With
`actor.kl_coef > 0` main loads a second, frozen copy of the checkpoint as
the reference policy. With `algorithm.adv_estimator=gae` it builds the
critic (`build_critic`): a copy of the actor's text backbone under a fresh
value head.

Across GPUs, one process each:

    torchrun --nproc_per_node 8 -m visrag_tpu_torch.driver.rl_main \
        --data prompts.jsonl --checkpoint qwen_ckpt --output-dir out/ \
        --set actor.ulysses_size=2 [--set actor.sp_backend=ring]

(or --coordinator host:port --process-id i --num-processes n in each
process; `--device cpu` runs gloo ranks). The mesh is `mesh` of the
config with its seq axis sized from actor.ulysses_size and the replica
axis spanning nodes (`rl_mesh`); the actor, the reference policy and the
critic are sharded over it and the rollout is split over (replica, data)
(rl/trainer.py). Every rank reads the same prompts; rank 0 logs and
writes. rollout.tensor_parallel_size > 1 sizes the mesh's model axis:
the rollout then runs tensor-parallel over each model group (the hybrid
engine) while the update stays FSDP2 over the other axes.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import os
import sys


def engine_settings(cfg) -> dict:
    """The rollout engine's settings from the RL config: 8 slots, room for
    the longest prompt plus response, prompt buckets 512-4096; long prompts
    prefill chunk by chunk (2048 tokens unless configured) so running
    decodes never stall behind a whole 15k-token forward, and the prefix
    cache then reuses the shared
    instruction prefix across the step's prompts (cleared on every weight
    update by Engine.set_params). `rollout.kv_cache_dtype` picks bf16 or
    int8 KV pools, as the JAX driver passes it; the old and reference
    log-prob passes stay bf16 either way (they run whole-sequence forwards,
    not the engine)."""
    r = cfg.rollout
    cpt = r.chunked_prefill_tokens
    if cpt is None and r.max_prompt_length >= 4096:
        cpt = 2048
    # as the JAX driver: the engine then takes the gcd block size (8 tokens
    # at 15000 + 1536 = 16536), which the paged decode kernel reads
    max_len = r.max_prompt_length + r.max_response_length
    buckets = tuple(b for b in (512, 1024, 2048, 4096) if b <= max_len) \
        or (max_len,)
    return dict(num_slots=8, max_len=max_len, prompt_buckets=buckets,
                chunked_prefill_tokens=cpt, cache_dtype=r.kv_cache_dtype,
                prefix_cache=bool(r.prefix_cache and cpt is not None))


def rl_mesh(cfg):
    """The RL job's mesh (None without a process group): the config's
    mesh with seq sized from actor.ulysses_size (the reference's
    ulysses_sequence_parallel_size, fsdp_workers.py:119), model from
    rollout.tensor_parallel_size (the hybrid engine's rollout TP, as the
    JAX driver sizes it) and the replica axis spanning nodes; a layout
    that the processes cannot fill raises ValueError."""
    import torch.distributed as dist

    from ..mesh import (build_mesh, mesh_shape, multihost_mesh_config,
                        num_nodes_of_job)
    mesh_cfg = cfg.mesh
    if cfg.actor.ulysses_size > 1:
        mesh_cfg = dataclasses.replace(mesh_cfg, seq=cfg.actor.ulysses_size)
    if cfg.rollout.tensor_parallel_size > 1:
        mesh_cfg = dataclasses.replace(
            mesh_cfg, model=cfg.rollout.tensor_parallel_size)
    mesh_cfg = multihost_mesh_config(mesh_cfg, num_nodes_of_job())
    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh_shape(mesh_cfg, world)                  # the layout, or ValueError
    return build_mesh(mesh_cfg) if dist.is_initialized() else None


def build_critic(model, cfg, *, seed: int = 0, mesh=None):
    """The GAE critic as the reference's driver builds it (a critic worker
    over the same base model with a fresh one-label head): QwenForValue
    whose text stack is a copy of the actor's (its own buffers: the critic
    trains them) and whose fp32 score head is drawn from a generator
    seeded with `seed` (lecun-normal, the JAX Dense's init), wrapped in a
    CriticTrainer on CriticConfig's optimizer and the run's batch and
    schedule horizon; with `mesh` (rl_mesh) the critic is sharded over
    it."""
    import torch

    from ..models.qwen25_vl import QwenForValue
    from ..rl.critic import CriticTrainer
    from .common import _trunc_normal_
    device = next(model.parameters()).device
    with torch.device("meta"):
        vmodel = QwenForValue(model.cfg.text)
    vmodel = vmodel.to_empty(device=device).eval()
    with torch.no_grad():
        vmodel.model.load_state_dict(model.model.state_dict())
        std = vmodel.score.weight.shape[1] ** -0.5 / 0.87962566103423978
        _trunc_normal_(vmodel.score.weight, std,
                       torch.Generator(device=device).manual_seed(seed))
    return CriticTrainer(vmodel, cfg.critic,
                         global_batch_size=cfg.trainer.global_batch_size,
                         total_steps=cfg.trainer.total_steps, mesh=mesh)


def build_trainer(model, cfg, processor, tok, *, ref_model=None,
                  critic=None, mesh=None):
    """The RLTrainer as the driver wires it: the reward manager and the
    token ids of its span tags, the image token banned in rollouts, the
    engine settings, batch decoding through the tokenizer; `critic` (from
    build_critic) for adv_estimator "gae"; `mesh` (rl_mesh) to train
    across ranks."""
    from ..rl.reward_manager import RewardManager
    from ..rl.trainer import RLTrainer

    # the reward manager owns the channel list + span-tag table; tags are
    # encoded for exactly the spans it declares (custom reward modules may
    # declare their own via REWARD_CHANNELS/CHANNEL_SPANS exports)
    reward_manager = RewardManager(
        cfg.reward, max_response_length=cfg.rollout.max_response_length)
    tags = {t: tok.encode(t, add_special_tokens=False)
            for t in sorted(reward_manager.required_tags)}
    # ban the image token in rollout sampling (the reference's logit_bias
    # {image_token_id: -100}, vllm_rollout_spmd.py:42-49) — a sampled
    # <image> mid-response would enter the update with a dangling slot map
    banned = []
    image_token = getattr(processor, "image_token", None)
    if image_token is not None:
        banned.append(tok.convert_tokens_to_ids(image_token))
    return RLTrainer(
        model, cfg, tokenizer_decode=lambda ids: tok.decode(ids),
        tokenizer_batch_decode=lambda seqs: tok.batch_decode(
            list(seqs), skip_special_tokens=cfg.reward.skip_special_tokens),
        reward_manager=reward_manager, tag_token_ids=tags,
        eos_token_ids=[tok.eos_token_id],
        engine_kwargs=engine_settings(cfg), ref_model=ref_model,
        banned_token_ids=banned, critic=critic, mesh=mesh)


def run_training(trainer, cfg, rows, encode_row, *, val_rows=None,
                 tracker=None, save_final: bool = True):
    """Dataset → checkpointable prompt cursor → auto-resume → fit → final
    save (skipped when the last step's periodic save just wrote it, or with
    save_final=False). rows / val_rows: paths of jsonl (or parquet) files
    of rows {problem, answer, images?}. → fit's history."""
    from ..data.datasets import RLHFDataset, StatefulIterator, batched
    dataset = RLHFDataset(rows, encode_row,
                          max_prompt_length=cfg.rollout.max_prompt_length)
    # checkpointable prompt cursor (StatefulDataLoader role): resume
    # continues at the exact dataset row with the saved rng
    row_iter = StatefulIterator(lambda: iter(dataset), cycle=True)
    trainer.data_iter = row_iter
    if trainer.maybe_resume():  # auto-resume (ray_trainer.py:346-373)
        print(f"resumed from step {trainer.step} "
              f"(data cursor {row_iter.state()})", file=sys.stderr)
    val_prompts = None
    if val_rows is not None:
        val_prompts = list(RLHFDataset(
            val_rows, encode_row,
            max_prompt_length=cfg.rollout.max_prompt_length))

    def prompt_batches():
        # cycling row cursor: epochs until total_steps, checkpointable
        yield from batched(row_iter, cfg.trainer.rollout_batch_size)

    history = trainer.fit(
        prompt_batches(), val_prompts=val_prompts, tracker=tracker,
        logger=(lambda s, m: tracker.log(m, s)) if tracker else None)
    t = cfg.trainer
    just_saved = t.save_freq > 0 and history \
        and trainer.step % t.save_freq == 0
    if save_final and not just_saved:
        trainer.save()
    return history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None)
    ap.add_argument("--data", required=True,
                    help="jsonl rows {problem, answer, images?}")
    ap.add_argument("--val-data", default=None,
                    help="optional validation jsonl (same schema)")
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--remat", default="none",
                    choices=("none", "mlp", "full"),
                    help="recompute in the update's backward: nothing, each "
                         "block's MLP, or whole blocks")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (multi-process runs)")
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    args = ap.parse_args(argv)
    from ..mesh import distributed
    with distributed(args.coordinator, args.process_id, args.num_processes,
                     args.device) as (pid, _):
        return _run(args, pid)


def _run(args, pid):
    from ..config import RLConfig, dump_config, load_config
    from ..mesh import local_device
    from ..utils.tracker import Tracker
    from .common import (build_qwen25_vl, encode_qwen_prompt_row,
                         get_processor, get_tokenizer, load_safetensors_dir,
                         qwen_config_from_checkpoint)

    cfg = load_config(RLConfig, yaml_path=args.config, dotlist=args.set)
    mesh = rl_mesh(cfg)
    # checkpoints and the tracker live under --output-dir
    cfg.trainer.output_dir = args.output_dir
    os.makedirs(args.output_dir, exist_ok=True)
    if pid == 0:
        dump_config(cfg, os.path.join(args.output_dir, "run_config.json"))

    processor = get_processor(args.checkpoint)
    # text-only checkpoints have no processor (get_processor → None);
    # tokenizers also implement apply_chat_template, so fall back to it
    tok = processor.tokenizer if processor is not None \
        else get_tokenizer(args.checkpoint)
    if processor is None:
        processor = tok
    state = load_safetensors_dir(args.checkpoint)
    mcfg = qwen_config_from_checkpoint(args.checkpoint, state)
    remat = {"none": False, "mlp": "mlp", "full": True}[args.remat]
    text = dataclasses.replace(mcfg.text, remat=remat)
    if cfg.actor.ulysses_size > 1 and cfg.actor.sp_backend != "ulysses":
        # the update's sequence-parallel attention (ring: P2P k/v rotation)
        text = dataclasses.replace(text, sp_backend=cfg.actor.sp_backend)
    mcfg = dataclasses.replace(mcfg, text=text)
    model = build_qwen25_vl(mcfg, device=local_device(args.device),
                            state=state)
    del state
    ref_model = copy.deepcopy(model) if cfg.actor.kl_coef > 0 else None
    critic = build_critic(model, cfg, mesh=mesh) \
        if cfg.algorithm.adv_estimator == "gae" else None

    trainer = build_trainer(model, cfg, processor, tok, ref_model=ref_model,
                            critic=critic, mesh=mesh)
    tracker = Tracker(args.output_dir if pid == 0 else None)

    def encode_row(row):
        return encode_qwen_prompt_row(row, processor, tok, mcfg, cfg.rollout)

    run_training(trainer, cfg, args.data, encode_row,
                 val_rows=args.val_data, tracker=tracker)
    tracker.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
