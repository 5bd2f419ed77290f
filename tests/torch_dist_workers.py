"""Multi-rank jobs for the port's distributed tests: gloo ranks on the CPU.

`spawn(target, world, *args)` starts `world` processes (the spawn method),
joins them into one gloo group at a free localhost port through
visrag_tpu_torch.mesh.init_distributed, runs target(rank, world, *args) in
each and returns the ranks' results in rank order. Every wait has a
timeout, a rank that fails raises its traceback here, and a job that hangs
is killed. The targets live in this module, which imports no jax: a
spawned child imports only what its target needs.
"""

from __future__ import annotations

import queue
import sys
import traceback

JOB_TIMEOUT = 240


def _child(target, rank, world, port, out, args, timeout):
    import faulthandler
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    # a rank that hangs prints where before the parent kills it
    faulthandler.dump_traceback_later(max(timeout - 20, 5))
    try:
        from visrag_tpu_torch.mesh import init_distributed
        init_distributed(f"localhost:{port}", rank, world, "cpu")
        result = target(rank, world, *args)
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in
                        ("jax", "jaxlib", "flax", "visrag_tpu"))
        if leaked:
            raise ImportError(f"a rank imported {leaked[:5]}")
        out.put((rank, True, result))
    except BaseException:      # handed to the parent, raised there
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(target, world: int, *args, timeout: float = JOB_TIMEOUT):
    import multiprocessing as mp
    import time
    from visrag_tpu_torch.mesh import free_port
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_child,
                         args=(target, r, world, port, out, args, timeout))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        for _ in range(world):
            try:
                rank, ok, payload = out.get(
                    timeout=max(deadline - time.monotonic(), 1.0))
            except queue.Empty:
                raise TimeoutError(f"{target.__name__} at {world} ranks "
                                   f"gave no result within {timeout} s")
            (results.__setitem__(rank, payload) if ok
             else errors.append(f"rank {rank}:\n{payload}"))
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert not any(p.is_alive() for p in procs)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [results[r] for r in range(world)]


# ---- shared tiny inputs -----------------------------------------------------


def tiny_pcfg():
    """The tiny retriever's pipeline, as build_visrag_ret(tiny=True)."""
    from visrag_tpu_torch.preprocess import PipelineConfig
    return PipelineConfig(seq_len=64, query_num=4, patch_size=2, src_grid=4,
                          scale_resolution=8, max_patches=64)


def encode_batch(items, slots=None):
    """items → a finished EncodeBatch on the CPU (MockTokenizer)."""
    from visrag_tpu_torch.preprocess import MockTokenizer, build_encode_batch
    from visrag_tpu_torch.preprocess.device import (finish_encode_batch,
                                                    pos_table_tensor)
    pcfg = tiny_pcfg()
    raw = build_encode_batch(MockTokenizer(), items, pcfg,
                             n_slice_slots=slots, device_mode=True)
    return finish_encode_batch(raw, pos_table_tensor(pcfg.src_grid, "cpu"))


def tiny_retriever(params):
    from visrag_tpu_torch.models.hf_loader import from_jax_params
    from visrag_tpu_torch.models.visrag_ret import VisRAGRet, VisRAGRetConfig
    model = VisRAGRet(VisRAGRetConfig.tiny())
    from_jax_params(model, params)
    return model


def micro_batches(items_q, items_p, micro):
    return [(encode_batch(items_q[i:i + micro]),
             encode_batch(items_p[i:i + micro]))
            for i in range(0, len(items_q), micro)]


# ---- retrieval --------------------------------------------------------------


def sharded_search(rank, world, queries, corpus, k, chunk_rows):
    """make_sharded_topk through StreamingSearcher(mesh=...), fp32 and
    int8, the corpus whole and in chunks of chunk_rows; self_retrieve."""
    from visrag_tpu_torch.config import MeshConfig
    from visrag_tpu_torch.mesh import build_mesh
    from visrag_tpu_torch.retrieval.search import (StreamingSearcher,
                                                   self_retrieve)
    mesh = build_mesh(MeshConfig())
    out = {}
    for quant in ("none", "int8"):
        searcher = StreamingSearcher(k, "cpu", quant, mesh=mesh)
        out[quant] = searcher.search(queries, [(corpus, 0)])
        chunks = [(corpus[i:i + chunk_rows], i)
                  for i in range(0, len(corpus), chunk_rows)]
        out[quant + "_chunks"] = searcher.search(queries, chunks)
    out["self"] = self_retrieve(
        queries, [f"q{i}" for i in range(len(queries))], 3, "cpu", mesh=mesh)
    return out


def dp_encode_and_eval(rank, world, params, items, eval_argvs):
    """make_encode_step over the ranks (every rank gets the global batch's
    representations in the global order), then eval_retriever.main with
    each argv in the job's group."""
    import torch
    from visrag_tpu_torch.config import MeshConfig
    from visrag_tpu_torch.driver.eval_retriever import main
    from visrag_tpu_torch.mesh import build_mesh, local_slice
    from visrag_tpu_torch.retrieval.encode import make_encode_step
    model = tiny_retriever(params).eval()
    mesh = build_mesh(MeshConfig())

    @torch.inference_mode()
    def apply(batch):
        return model(batch)

    step = make_encode_step(apply, mesh)
    reps = step(batch=encode_batch(local_slice(items, mesh)))
    return reps.numpy(), [main(argv) for argv in eval_argvs]


# ---- training ---------------------------------------------------------------


def retriever_steps(rank, world, params, items_q, items_p, train_kw,
                    mesh_kw, runs, resume_from=None, save_to=None):
    """For each (grad_cache, micro) in runs: a fresh trainer on the mesh,
    two steps on this rank's block of the global batch → the metrics and,
    on rank 0, the full weights after them. With resume_from: a fresh
    trainer resumed from that checkpoint → its full weights and optimizer
    states (rank 0). With save_to: the last run's trainer saves there."""
    from visrag_tpu_torch.config import MeshConfig, TrainConfig
    from visrag_tpu_torch.mesh import build_mesh, local_slice
    from visrag_tpu_torch.training.checkpoint import full_tensors
    from visrag_tpu_torch.training.trainer import RetrieverTrainer
    mesh = build_mesh(MeshConfig(**mesh_kw))
    lq, lp = local_slice(items_q, mesh), local_slice(items_p, mesh)
    out = {"runs": []}
    tr = None
    for grad_cache, micro in runs:
        cfg = TrainConfig(**train_kw, grad_cache=grad_cache,
                          grad_cache_micro_batch_size=micro)
        tr = RetrieverTrainer(tiny_retriever(params), cfg, total_steps=10,
                              mesh=mesh)
        batch = micro_batches(lq, lp, micro if grad_cache else len(lq))
        hist = [tr.train_step(batch) for _ in range(2)]
        state = full_tensors(tr.model.state_dict())
        out["runs"].append((hist, _numpy(state) if rank == 0 else None))
    if save_to is not None:
        tr.save(save_to)
    if resume_from is not None:
        cfg = TrainConfig(**train_kw)
        fresh = RetrieverTrainer(tiny_retriever(params), cfg, total_steps=10,
                                 mesh=mesh)
        step = fresh.maybe_resume(resume_from)
        tree = full_tensors({"model": fresh.model.state_dict(),
                             "optimizer": fresh.optimizer.state_dict()})
        out["resumed"] = (step, _numpy(tree) if rank == 0 else None)
    return out


def _numpy(tree):
    import torch
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().numpy()
    return tree


def sft_steps(rank, world, state, cfg_kw, sft_kw, mesh_kw, batch, steps):
    """make_sft_step on the mesh from the same weights: `steps` steps on
    the global batch → the metrics and, on rank 0, the full text weights."""
    import dataclasses
    import torch
    from visrag_tpu_torch.config import MeshConfig
    from visrag_tpu_torch.mesh import build_mesh
    from visrag_tpu_torch.models.qwen25_vl import Qwen25VL, Qwen25VLConfig
    from visrag_tpu_torch.training.checkpoint import full_tensors
    from visrag_tpu_torch.training.sft import SFTConfig, make_sft_step
    cfg = Qwen25VLConfig.tiny()
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text,
                                                            **cfg_kw))
    model = Qwen25VL(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    mesh = build_mesh(MeshConfig(**mesh_kw))
    _, step = make_sft_step(model, SFTConfig(**sft_kw), mesh)
    hist = [{k: float(v) for k, v in step(batch).items()}
            for _ in range(steps)]
    full = full_tensors(model.state_dict())
    return hist, (_numpy(full) if rank == 0 else None)


# ---- sequence parallelism ---------------------------------------------------


def sp_attention(rank, world, cases):
    """Each case (q, k, v, seg, use_lengths, mesh_kw, backend):
    sp_flash_attention on this rank's rows (mesh.local_slice) and sequence
    block, with the rows' full segment ids or (use_lengths) their lengths;
    the loss sum(out**2) over valid rows differentiated. → every case's
    (out, dq, dk, dv) blocks."""
    import torch
    from visrag_tpu_torch.config import MeshConfig
    from visrag_tpu_torch.mesh import SEQ, axis_index, build_mesh, local_slice
    from visrag_tpu_torch.parallel.ulysses import sp_flash_attention
    out = []
    for q, k, v, seg, use_lengths, mesh_kw, backend in cases:
        mesh = build_mesh(MeshConfig(**mesh_kw))
        n, r = mesh_kw.get("seq", 1), axis_index(mesh, SEQ)
        blk = slice(r * q.shape[1] // n, (r + 1) * q.shape[1] // n)
        t = [torch.from_numpy(local_slice(x, mesh)[:, blk]).requires_grad_()
             for x in (q, k, v)]
        seg = torch.from_numpy(local_slice(seg, mesh))
        kw = {"lengths": (seg > 0).sum(1)} if use_lengths \
            else {"q_seg": seg, "kv_seg": seg}
        o = sp_flash_attention(*t, causal=True, mesh=mesh, backend=backend,
                               **kw)
        ((o ** 2) * (seg[:, blk] > 0)[:, :, None, None]).sum().backward()
        out.append([x.detach().numpy() for x in (o, *(a.grad for a in t))])
    return out


# ---- the mesh ---------------------------------------------------------------


def mesh_layout(rank, world, layouts, rows):
    """For each mesh layout: this rank's coordinates, its groups' ranks
    and its local_slice of `rows`."""
    import torch.distributed as dist
    from visrag_tpu_torch.config import MeshConfig
    from visrag_tpu_torch.mesh import (BATCH_AXES, WEIGHT_AXES, axis_group,
                                       build_mesh, local_slice)
    out = []
    for kw in layouts:
        mesh = build_mesh(MeshConfig(**kw))
        out.append({
            "coords": {a: mesh.get_local_rank(a)
                       for a in mesh.mesh_dim_names},
            "groups": {"+".join(axes): dist.get_process_group_ranks(
                axis_group(mesh, *axes))
                for axes in (("data",), ("seq",), BATCH_AXES, WEIGHT_AXES)},
            "slice": local_slice(rows, mesh)})
    return out


def training_job(rank, world, retriever_args, sft_args, lora_args=None,
                 driver_args=None, rl_args=None):
    """retriever_steps, sft_steps, lora_steps, driver_runs and rl_job in
    one job (each argument tuple is theirs after rank and world; None
    skips it)."""
    return tuple(fn(rank, world, *args) if args else None
                 for fn, args in ((retriever_steps, retriever_args),
                                  (sft_steps, sft_args),
                                  (lora_steps, lora_args),
                                  (driver_runs, driver_args),
                                  (rl_job, rl_args)))


# ---- LoRA -------------------------------------------------------------------


def lora_steps(rank, world, params, items_q, items_p, train_kw, mesh_kw,
               lora_kw, steps):
    """LoRA adapters (lora_init from generator seed 0) on the tiny
    retriever, RetrieverTrainer(params=adapters, mesh=...) for `steps`
    steps on this rank's block of the global batch → the metrics and, on
    rank 0, the full adapters and the merged state (lora_merged_state of
    the gathered weights)."""
    import torch
    from visrag_tpu_torch.config import MeshConfig, TrainConfig
    from visrag_tpu_torch.mesh import build_mesh, local_slice
    from visrag_tpu_torch.training.checkpoint import full_tensors
    from visrag_tpu_torch.training.lora import lora_init, lora_merged_state
    from visrag_tpu_torch.training.trainer import RetrieverTrainer
    mesh = build_mesh(MeshConfig(**mesh_kw))
    model = tiny_retriever(params)
    adapters = lora_init(model, generator=torch.Generator().manual_seed(0),
                         **lora_kw)
    tr = RetrieverTrainer(model, TrainConfig(**train_kw), total_steps=10,
                          params=adapters, mesh=mesh)
    lq, lp = local_slice(items_q, mesh), local_slice(items_p, mesh)
    batch = micro_batches(lq, lp, len(lq))
    hist = [tr.train_step(batch) for _ in range(steps)]
    state = full_tensors(tr.model.state_dict())
    if rank:
        return hist, None
    return hist, _numpy({"adapters": {k: v for k, v in state.items()
                                      if ".lora_" in k},
                         "merged": lora_merged_state(tr.model, state)})


def driver_runs(rank, world, argvs):
    """A driver's main (module path, argv) in the job's group, each."""
    import importlib
    return [importlib.import_module(mod).main(argv) for mod, argv in argvs]


# ---- RS-GRPO ----------------------------------------------------------------

RL_TAGS = {"<think>": [50], "<evidence>": [51], "<answer>": [52]}
RL_ENGINE = dict(num_slots=4, max_len=64, prompt_buckets=(16,))


def tiny_qwen(state, **text_over):
    """The tiny Qwen2.5-VL (fp32) holding `state` (numpy, port names)."""
    import dataclasses
    import torch
    from visrag_tpu_torch.models.qwen25_vl import Qwen25VL, Qwen25VLConfig
    cfg = Qwen25VLConfig.tiny()
    if text_over:
        cfg = dataclasses.replace(cfg, text=dataclasses.replace(
            cfg.text, **text_over))
    model = Qwen25VL(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


def tiny_critic(vstate):
    import torch
    from visrag_tpu_torch.models.qwen25_vl import QwenForValue, \
        QwenTextConfig
    model = QwenForValue(QwenTextConfig.tiny())
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in vstate.items()})
    return model


def rl_config(actor_kw=None, **over):
    """RLConfig with lr 1e-3, the actor's `actor_kw`, and top-level
    sections replaced field by field from `over` ({section: {field:
    value}})."""
    import dataclasses
    from visrag_tpu_torch.config import RLConfig
    cfg = RLConfig()
    cfg = dataclasses.replace(cfg, actor=dataclasses.replace(
        cfg.actor, lr=1e-3, **(actor_kw or {})))
    for section, fields in over.items():
        cfg = dataclasses.replace(cfg, **{section: dataclasses.replace(
            getattr(cfg, section), **fields)})
    return cfg


def rl_trainer(state, cfg, mesh, text_over=None, ref=False, critic=None):
    from visrag_tpu_torch.rl.trainer import RLTrainer
    return RLTrainer(tiny_qwen(state, **(text_over or {})), cfg,
                     tokenizer_decode=lambda ids: (
                         "<answer>x</answer>" if sum(ids) % 2 == 0
                         else "wrong"),
                     tag_token_ids=RL_TAGS, engine_kwargs=RL_ENGINE,
                     ref_model=tiny_qwen(state) if ref else None,
                     critic=critic, mesh=mesh)


def rl_update(trainer, batch):
    """The actor's and the reference policy's log-probs, then one
    update_policy, with ref log-probs the reference pass less 0.1 on
    response tokens → (old log-probs, ref pass, metrics)."""
    b = dict(batch)
    b["old_log_probs"] = trainer.compute_log_probs(trainer.model, b)
    ref = trainer.compute_log_probs(trainer.ref_model, b)
    b["ref_log_probs"] = ref - 0.1 * b["response_mask"]
    return b["old_log_probs"], ref, trainer.update_policy(b)


def critic_update(critic, batch):
    """compute_values, then one update on batch's values and returns →
    (values, metrics)."""
    values = critic.compute_values(batch)
    return values, critic.update(dict(batch))


def _state(module, rank):
    from visrag_tpu_torch.training.checkpoint import full_tensors
    full = full_tensors(module.state_dict())
    return _numpy(full) if rank == 0 else None


def rl_job(rank, world, state, vstate, cases):
    """Each case (kind, mesh layout, arguments) on a fresh mesh:
      "update" (batch, actor_kw, text_over): rl_update → (old log-probs,
        ref pass, metrics, the actor's full weights);
      "critic" (batch,): critic_update → (values, metrics, full weights);
      "rollout" (prompts, n): a greedy rollout → its fields;
      "resume" (batch, from_dir, to_dir): a GAE trainer resumes from
        from_dir → its full state; then it saves to to_dir;
      "fit" (prompts, cfg over, steps): a greedy rollout of `prompts` at
        seed 5, then `steps` steps of fit on them → (the rollout's
        responses, each step's metrics, the actor's full weights, the
        engine's tensor-parallel size and prefill count)."""
    import dataclasses
    from visrag_tpu_torch.config import MeshConfig
    from visrag_tpu_torch.mesh import build_mesh
    from visrag_tpu_torch.rl.critic import CriticTrainer
    out = []
    for kind, mesh_kw, args in cases:
        mesh = build_mesh(MeshConfig(**mesh_kw))
        if kind == "update":
            batch, actor_kw, text_over = args
            t = rl_trainer(state, rl_config(actor_kw), mesh, text_over,
                           ref=True)
            out.append((*rl_update(t, batch), _state(t.model, rank)))
        elif kind == "critic":
            cfg = rl_config(critic={"lr": 1e-3})
            c = CriticTrainer(tiny_critic(vstate), cfg.critic, mesh=mesh,
                              global_batch_size=cfg.trainer
                              .global_batch_size)
            out.append((*critic_update(c, args[0]), _state(c.model, rank)))
        elif kind == "rollout":
            prompts, n = args
            t = rl_trainer(state, rl_config(), mesh)
            rb = t.rollout(prompts, 0, n=n, temperature=0.0)
            out.append({f.name: getattr(rb, f.name)
                        for f in dataclasses.fields(rb)})
        elif kind == "fit":
            prompts, over, steps = args
            t = rl_trainer(state, rl_config(**over), mesh)
            rb = t.rollout([dict(p) for p in prompts], 5)
            engine = (t._engine.tp, t._engine.prefill_count)
            hist = t.fit(iter([prompts] * steps))
            out.append((rb.responses, [m for _, m in hist],
                        _state(t.model, rank), engine))
        else:
            batch, from_dir, to_dir = args
            cfg = rl_config(algorithm={"adv_estimator": "gae"},
                            trainer={"output_dir": from_dir})
            c = CriticTrainer(tiny_critic(vstate), cfg.critic, mesh=mesh)
            t = rl_trainer(state, cfg, mesh, critic=c)
            ok = t.maybe_resume()
            got = {"model": _state(t.model, rank),
                   "critic": _state(c.model, rank),
                   "optimizer": _numpy_opt(t.optimizer, rank),
                   "critic_optimizer": _numpy_opt(c.optimizer, rank),
                   "rng": t._rng.get_state().numpy(), "step": t.step,
                   "ok": ok}
            t.cfg.trainer.output_dir = to_dir
            t.save()
            out.append(got)
    return out


def _numpy_opt(optimizer, rank):
    from visrag_tpu_torch.training.checkpoint import full_tensors
    full = full_tensors(optimizer.state_dict())
    return _numpy(full) if rank == 0 else None


# ---- tensor parallelism -----------------------------------------------------


def tp_model(spec):
    """A port generation model from (kind, numpy state, config overrides):
    kind "qwen" (Qwen2.5-VL tiny, overrides on its text config),
    "minicpm" (MiniCPM-2B tiny) or "minicpmv26" (MiniCPM-V 2.6 tiny)."""
    import torch
    kind, state, over = spec
    if kind == "qwen":
        return tiny_qwen(state, **over).eval()
    if kind == "minicpm":
        from visrag_tpu_torch.models.minicpm import (MiniCPMForGeneration,
                                                     MiniCPMGenConfig)
        model = MiniCPMForGeneration(MiniCPMGenConfig.tiny(**over))
    else:
        from visrag_tpu_torch.models.minicpmv26 import (
            MiniCPMV26Config, MiniCPMV26ForGeneration)
        model = MiniCPMV26ForGeneration(MiniCPMV26Config.tiny(**over))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model.eval()


def _tp_engine(mesh, spec, engine_kw, prompts, sampling_kw, n):
    """Engine(mesh=) over the rank's shard → the requests' ids and summed
    log-probabilities, and the engine's counters and pool heads."""
    from visrag_tpu_torch.mesh import shard_module_tp
    from visrag_tpu_torch.serving.engine import Engine
    from visrag_tpu_torch.serving.sampling import SamplingParams
    engine = Engine(shard_module_tp(tp_model(spec), mesh), mesh=mesh,
                    **engine_kw)
    engine.record_schedule = True
    reqs = engine.generate_detailed(prompts, SamplingParams(**sampling_kw),
                                    n=n)
    pool = engine.k_cache.data if hasattr(engine.k_cache, "data") \
        else engine.k_cache
    return dict(ids=[r.output_ids for r in reqs],
                logp=[r.cum_logprob for r in reqs],
                prefills=(engine.prefill_count, engine.prefill_dispatches),
                prefix_hits=engine.prefix_hits, sched=engine.sched_log,
                kv_heads=pool.shape[2], free=len(engine.allocator.free))


def _tp_modules(mesh, spec, ids, mask, decode_ids, vision):
    """The rank's shard (mesh.shard_module_tp) of the Qwen model: the
    prefill's logits (all positions) and its own kv heads' K/V, three
    decode steps over a dense cache of those heads, the vision tower's
    output and the forward's logits on the prefill's rows."""
    import numpy as np
    import torch
    from visrag_tpu_torch.mesh import shard_module_tp
    shard = shard_module_tp(tp_model(spec), mesh)
    t = torch.from_numpy
    out = {}
    with torch.no_grad():
        logits, k, v = shard.prefill(t(ids), attention_mask=t(mask))
        out["prefill"] = (logits.numpy(), k.numpy(), v.numpy())
        s = int(mask.sum())
        layers, _, _, kvh, d = k.shape
        kc = torch.zeros((layers, 1, s + len(decode_ids), kvh, d))
        vc = torch.zeros_like(kc)
        kc[:, :, :s], vc[:, :, :s] = k[:, :, :s], v[:, :, :s]
        steps = []
        for i, tok in enumerate(decode_ids):
            pos = torch.full((3, 1, 1), s + i)
            steps.append(shard.decode(torch.tensor([[tok]]), pos, kc, vc,
                                      torch.tensor([s + i + 1])).numpy())
        out["decode"] = np.stack(steps)
        out["vision"] = shard.encode_images(
            {key: t(np.asarray(a)) for key, a in vision.items()}).numpy()
        out["forward"] = shard(t(ids), attention_mask=t(mask))[0].numpy()
    return out


def _tp_refusals(mesh, spec):
    """What tensor parallelism refuses, each's ValueError message (None
    where nothing raised): Engine(mesh=) over a whole model, and an int8
    QuantLinear that the rule would slice."""
    import torch
    from visrag_tpu_torch.mesh import shard_module_tp
    from visrag_tpu_torch.models.common import QuantLinear
    from visrag_tpu_torch.serving.engine import Engine
    int8 = torch.nn.ModuleDict({"q_proj": QuantLinear(8, 8)})
    out = []
    for make in (lambda: Engine(tp_model(spec), mesh=mesh),
                 lambda: shard_module_tp(int8, mesh)):
        try:
            make()
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


def tp_job(rank, world, cases, rl_args=None):
    """Each case (kind, mesh layout, arguments) on a fresh mesh:
      "engine" (model spec, engine kwargs, prompts, sampling kwargs, n):
        _tp_engine;
      "modules" (model spec, ids, mask, decode ids, vision): _tp_modules;
      "refusals" (model spec,): _tp_refusals;
      "rl_mesh" (tp,): rl_main.rl_mesh of a config with
        rollout.tensor_parallel_size tp → its axis sizes;
    then rl_job with rl_args (None skips it)."""
    from visrag_tpu_torch.config import MeshConfig, RLConfig
    from visrag_tpu_torch.driver.rl_main import rl_mesh
    from visrag_tpu_torch.mesh import axis_sizes, build_mesh
    out = []
    for kind, mesh_kw, args in cases:
        if kind == "rl_mesh":
            cfg = RLConfig()
            cfg.rollout.tensor_parallel_size = args[0]
            out.append(axis_sizes(rl_mesh(cfg)))
            continue
        mesh = build_mesh(MeshConfig(**mesh_kw))
        fn = {"engine": _tp_engine, "modules": _tp_modules,
              "refusals": _tp_refusals}[kind]
        out.append(fn(mesh, *args))
    return out, (rl_job(rank, world, *rl_args) if rl_args else None)
