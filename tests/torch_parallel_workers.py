"""Rank processes of the port's multi-rank CPU tests.

``run_ranks(fn, world, payload, tmp)`` starts ``world`` processes (spawn),
forms a gloo process group over a ``FileStore`` in each, calls ``fn(rank,
world, payload)`` there with one torch thread and returns every rank's
result, in rank order. ``run_launched_ranks(fn, world, per_node, payload,
tmp)`` instead gives each process the environment ``torchrun --nnodes
world/per_node --nproc_per_node per_node`` gives it (``RANK``,
``LOCAL_RANK = RANK % per_node``, ``NODE_RANK``, ``MASTER_ADDR`` /
``MASTER_PORT`` on localhost ...) and forms no group: the code under test
joins it. A rank that raises, or a run that outlives its timeout, fails
the call with the ranks' tracebacks. This module imports the port and
torch only: the ranks load no JAX.
"""
import contextlib
import multiprocessing
import os
import signal
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from e4t_diffusion_torch.config import AttributeDict
from e4t_diffusion_torch.diffusion import pipeline as pipeline_mod
from e4t_diffusion_torch.diffusion.pipeline import (E4TModules,
                                                    StableDiffusionE4TPipeline)
from e4t_diffusion_torch.diffusion.schedulers import DDPMScheduler
from e4t_diffusion_torch.models import unet as unet_mod
from e4t_diffusion_torch.ops import quant
from e4t_diffusion_torch.parallel import mesh as pmesh
from e4t_diffusion_torch.training import train_step as ts
from e4t_diffusion_torch.utils import artifacts
from e4t_diffusion_torch.utils.tokenizer import CLIPTokenizer

# each spawn's own bound: a hang fails its test, not the suite
TIMEOUT_S = 100


def _entry(fn, rank, world, tmp, payload_path, env=None):
    torch.set_num_threads(1)
    try:
        if env is None:
            store = dist.FileStore(os.path.join(tmp, "store"), world)
            pmesh.initialize(rank, world, torch.device("cpu"), store=store)
        else:
            os.environ.update(env)
        payload = torch.load(payload_path, weights_only=False)
        out = fn(rank, world, payload)
        torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_launched_ranks(fn, world, per_node, payload, tmp,
                       timeout=TIMEOUT_S):
    """``world`` ranks as ``world // per_node`` nodes of ``per_node``,
    each with torchrun's environment and no process group yet."""
    port = str(_free_port())
    envs = [{"MASTER_ADDR": "localhost", "MASTER_PORT": port,
             "RANK": str(r), "WORLD_SIZE": str(world),
             "LOCAL_RANK": str(r % per_node),
             "LOCAL_WORLD_SIZE": str(per_node),
             "NODE_RANK": str(r // per_node),
             "GROUP_RANK": str(r // per_node)} for r in range(world)]
    return run_ranks(fn, world, payload, tmp, timeout, envs)


def run_ranks(fn, world, payload, tmp, timeout=TIMEOUT_S, envs=None):
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    payload_path = os.path.join(tmp, "payload.pt")
    torch.save(payload, payload_path)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(
        fn, r, world, tmp, payload_path, envs[r] if envs else None))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = []
    for r in range(world):
        path = os.path.join(tmp, f"err{r}.txt")
        if os.path.exists(path):
            with open(path) as f:
                errors.append(f"rank {r}:\n{f.read()}")
    if hung or errors or any(p.exitcode for p in procs):
        raise AssertionError(f"ranks hung {hung} or failed (exit codes "
                             f"{[p.exitcode for p in procs]}):\n"
                             + "\n".join(errors))
    return [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False)
            for r in range(world)]


def tiny_modules(sds, mesh=None, unet_config=None):
    """The tiny modules on the CPU with the payload's weights, the UNet
    (``unet_config``, default the tiny one) split over ``mesh``'s tp."""
    modules = E4TModules.tiny(device="cpu")
    if unet_config is not None:
        modules.unet = unet_mod.UNet2DConditionModel(unet_config).eval(
        ).requires_grad_(False)
    modules.load_state_dicts({k: sds[k]
                              for k in ("unet", "vae", "text", "e4t")})
    if mesh is not None:
        pmesh.apply_tensor_parallel(modules.unet, mesh)
    return modules


# ---- training --------------------------------------------------------------

def train_step(mesh, p, cfg, zero1=False):
    """``p["updates"]`` (default 1) updates of the tiny train step
    (``cfg``: E4TTrainConfig fields) on this dp rank's rows of the
    payload's batch (its AdamW 8-bit where the payload says ``use_8bit``)
    -> the last call's metrics, the trainables before the first and after
    the last and the gradients AdamW saw last (the UNet's gathered to its
    unsplit layout), the optimizer state (unsharded over dp; under tp this
    rank's shards' state) and the trainables' local sizes."""
    modules = tiny_modules(p["sds"], mesh, p.get("unet_config"))
    cfg = ts.E4TTrainConfig(**cfg)
    trainable, _ = ts.split_trainable(modules, p["sds"]["offsets"], cfg,
                                      torch.float32)
    flat = [t for g in trainable.values() for t in g.values()]
    opt = ts.make_optimizer(flat, p["lr"], use_8bit=p.get("use_8bit", False),
                            zero1_group=mesh.dp_group if zero1 else None)
    seen = {}
    opt.register_step_pre_hook(lambda *_: seen.update(
        {g: {k: t.grad.clone() for k, t in group.items()}
         for g, group in trainable.items()}))
    step = ts.make_train_step(modules, DDPMScheduler(), cfg, trainable, opt,
                              lambda n: p["lr"], mesh=mesh)
    before = {g: {k: t.detach().clone() for k, t in group.items()}
              for g, group in trainable.items()}
    batch = {k: (v[mesh.rows(v.shape[0])] if k in ts._PER_SAMPLE else v)
             for k, v in p["batch"].items()}
    for _ in range(p.get("updates", 1)):
        metrics = {k: float(v) for k, v in step(batch).items()}
    after = {g: {k: t.detach().clone() for k, t in group.items()}
             for g, group in trainable.items()}
    if "unet" in after:
        after["unet"] = _unsplit(modules.unet, mesh, after["unet"])
        seen["unet"] = _unsplit(modules.unet, mesh, seen["unet"])
    return {"metrics": metrics, "after": after,
            "before": before if mesh.tp == 1 else None, "grads": seen,
            "specs": getattr(modules.unet, "tp_specs", {}),
            "optimizer": pmesh.consolidated_state_dict(opt),
            "numel": [t.numel() for t in flat]}


def _unsplit(unet, mesh, tensors):
    """{UNet parameter name: this rank's shard} in the unsplit layout."""
    out = dict(tensors)
    for name, kind in getattr(unet, "tp_specs", {}).items():
        if name in out:
            parts = [torch.empty_like(out[name]) for _ in range(mesh.tp)]
            dist.all_gather(parts, out[name].contiguous(),
                            group=mesh.tp_group)
            out[name] = pmesh._join(parts, kind)
    return out


def train_cases(rank, world, p):
    """Every training case of one spawn, in one process group; a case's
    entry of ``p["overrides"]`` replaces payload keys for it."""
    out = {}
    for name, tp, zero1, cfg in p["cases"]:
        case = {**p, **p.get("overrides", {}).get(name, {})}
        out[name] = train_step(pmesh.get_mesh(tp), case, cfg, zero1)
    return out


# ---- the pretraining CLI ---------------------------------------------------

def pretrain_sigterm(rank, world, p):
    """The pretraining CLI at dp=2 with ZeRO-1 on the payload's template
    set: rank 1 sends itself SIGTERM during its first update; every rank
    records its batches and draws.
    Then each rank restores the checkpoint the run wrote into fresh state."""
    from e4t_diffusion_torch import pretrain_e4t

    seen = {"ids": [], "pixels": [], "gen": []}
    saved = {}
    real_make = pretrain_e4t.make_train_step
    real_save = artifacts.save_train_state

    def make(*args, **kwargs):
        step = real_make(*args, **kwargs)

        def wrapped(batch, generator=None):
            seen["ids"].append(batch["input_ids"].clone())
            seen["pixels"].append(batch["pixel_values"].clone())
            seen["gen"].append(generator.get_state().clone())
            out = step(batch, generator)
            if rank == 1 and step.counts["calls"] == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        wrapped.counts, wrapped.resume = step.counts, step.resume
        return wrapped

    def save(*args, **kwargs):
        saved["generator"] = args[5].get_state().clone()
        return real_save(*args, **kwargs)

    real_templates = pretrain_e4t.resolve_templates
    pretrain_e4t.make_train_step = make
    artifacts.save_train_state = save
    pretrain_e4t.resolve_templates = lambda name: p["templates"]
    try:
        result = pretrain_e4t.main(p["argv"])
    finally:
        pretrain_e4t.make_train_step = real_make
        artifacts.save_train_state = real_save
        pretrain_e4t.resolve_templates = real_templates
    mesh = pmesh.get_mesh()
    # restore into fresh structures, as a resumed run does
    trainable = {g: {k: torch.zeros_like(t) for k, t in group.items()}
                 for g, group in result["trainable"].items()}
    flat = [t for g in trainable.values() for t in g.values()]
    opt = ts.make_optimizer(flat, 1e-3, zero1_group=mesh.dp_group)
    gen = torch.Generator().manual_seed(12345)
    ckpt = os.path.join(p["out"], f"checkpoint-{result['global_step']}")
    restored = artifacts.restore_train_state(ckpt, trainable, opt, gen,
                                             rank=rank)
    return {"global_step": result["global_step"], "seen": seen,
            "saved_generator": saved["generator"],
            "restored_generator": gen.get_state(),
            "restored": restored,
            "trainable": {g: {k: t.detach().clone() for k, t in grp.items()}
                          for g, grp in result["trainable"].items()},
            "restored_trainable": trainable,
            "optimizer": pmesh.consolidated_state_dict(result["optimizer"]),
            "restored_optimizer": pmesh.consolidated_state_dict(opt)}


def pretrain_cli(rank, world, p):
    """The pretraining CLI as a launched rank, joining the group from the
    environment itself; each rank writes under its own ``rank<r>/`` of the
    payload's root (so what each rank wrote can be told apart). Returns the
    metrics, every file under the rank's directory, and on rank 0 the
    artifact's tensors."""
    from e4t_diffusion_torch import pretrain_e4t

    out = os.path.join(p["root"], f"rank{rank}")
    real_templates = pretrain_e4t.resolve_templates
    pretrain_e4t.resolve_templates = lambda name: p["templates"]
    try:
        result = pretrain_e4t.main([*p["argv"], "--output_dir", out])
    finally:
        pretrain_e4t.resolve_templates = real_templates
    mesh = pmesh.get_mesh()
    artifact = {}
    step_dir = os.path.join(out, str(result["global_step"]))
    if os.path.isdir(step_dir):
        for name in ("encoder.pt", "weight_offsets.pt"):
            artifact[name] = torch.load(os.path.join(step_dir, name))
    files = sorted(os.path.relpath(os.path.join(d, f), out)
                   for d, _, names in os.walk(out) for f in names)
    return {"rank": mesh.rank, "world": mesh.world,
            "local_rank": int(os.environ["LOCAL_RANK"]),
            "metrics": result["metrics"], "files": files,
            "artifact": artifact}


# ---- sampling and the UNet -------------------------------------------------

def unet_forward(mesh, p):
    """The tiny UNet's eps and tap at tp (f32), and an attention module's
    output and input/weight gradients."""
    modules = tiny_modules(p["sds"], mesh)
    unet = modules.unet
    with torch.no_grad():
        eps, tap = unet(p["x"], p["t"], p["ctx"],
                        return_encoder_outputs="with_eps")
    block = unet.down_blocks[0].attentions[0].transformer_blocks[0]
    block.attn1.requires_grad_(True)
    x = p["attn_x"].clone().requires_grad_(True)
    y = block.attn1(x)
    (y * p["attn_dout"]).sum().backward()
    grads = {n: prm.grad for n, prm in block.attn1.named_parameters()}
    # every UNet site int8 on live scales: q/k/v by this rank's rows,
    # to_out by its columns, the live abs-max the MAX over the ranks (the
    # sampling loop's contexts)
    sites = pipeline_mod._unet_sites(unet, {}, True, None)
    with torch.no_grad(), contextlib.ExitStack() as stack:
        pipeline_mod._parallel_contexts(stack, mesh, None)
        stack.enter_context(quant.int8_sites(unet, sites))
        out8 = block.attn1(p["attn_x"])
    # q/k/v as one product: the concatenated local shards
    os.environ[unet_mod.FUSED_QKV_KNOB] = "1"
    try:
        with torch.no_grad():
            fused = (block.attn1(p["attn_x"]),
                     block.attn2(p["attn_x"], p["ctx"]))
    finally:
        del os.environ[unet_mod.FUSED_QKV_KNOB]
    return {"eps": eps, "tap": tap, "attn_out": y.detach(),
            "attn_dx": x.grad, "attn_grads": grads,
            "heads": block.attn1.heads, "attn_int8": out8,
            "fused_qkv": fused}


def make_pipeline(p, mesh, data_parallel, int8=False, lora=False,
                  int8_aux=False):
    modules = tiny_modules(p["sds"], mesh)
    tok = CLIPTokenizer.from_pretrained(p["tok_dir"], model_max_length=16)
    extra = {"lora_bank": p["lora"], "lora_scale": 0.8} if lora else {}
    return StableDiffusionE4TPipeline(
        modules, p["sds"]["offsets"], tok, AttributeDict(p["e4t_config"]),
        int8=int8, int8_aux=int8_aux, mesh=mesh,
        data_parallel=data_parallel, **extra)


def sample(pipe, p, **kwargs):
    return pipe(p["prompts"], p["image"], num_inference_steps=3,
                num_images_per_prompt=2, seed=7, **kwargs)


def serve_cases(rank, world, p):
    """The tp=2 UNet and attention, then sampling under dp=2 and tp=2."""
    out = {}
    tp2 = pmesh.get_mesh(tp=2)
    out["unet_tp2"] = unet_forward(tp2, p)
    dp2 = pmesh.get_mesh(tp=1)
    pipe = make_pipeline(p, dp2, data_parallel=True)
    out["dp_ddim"] = sample(pipe, p, guidance_scale=7.5)
    out["dp_euler_a"] = sample(pipe, p, guidance_scale=7.5,
                               scheduler_type="euler_ancestral")
    try:
        pipe(p["prompts"][0], p["image"], num_inference_steps=1,
             num_images_per_prompt=3)
    except ValueError as e:
        out["indivisible"] = str(e)
    out["dp_int8"] = sample(make_pipeline(p, dp2, True, int8=True), p,
                            guidance_scale=7.5)
    aux = make_pipeline(p, dp2, True, int8="static", int8_aux="static")
    out["dp_int8_aux"] = sample(aux, p, guidance_scale=7.5)
    out["dp_aux_amax"] = aux.aux_amax
    static = make_pipeline(p, tp2, False, int8="static")
    out["tp_int8_static"] = sample(static, p, guidance_scale=7.5)
    out["tp_int8_amax"] = static.act_amax
    out["tp_ddim"] = sample(make_pipeline(p, tp2, False), p,
                            guidance_scale=7.5)
    out["tp_lora"] = sample(make_pipeline(p, tp2, False, lora=True), p,
                            guidance_scale=7.5)
    return out


def single_process_sampling(p):
    """The references of ``serve_cases`` on one process (no group)."""
    mesh = pmesh.Mesh()
    pipe = make_pipeline(p, mesh, False)
    static = make_pipeline(p, mesh, False, int8="static")
    out = {"ddim": sample(pipe, p, guidance_scale=7.5),
           "euler_a": sample(pipe, p, guidance_scale=7.5,
                             scheduler_type="euler_ancestral"),
           "int8": sample(make_pipeline(p, mesh, False, int8=True), p,
                          guidance_scale=7.5),
           "int8_static": sample(static, p, guidance_scale=7.5),
           "lora": sample(make_pipeline(p, mesh, False, lora=True), p,
                          guidance_scale=7.5)}
    out["int8_amax"] = static.act_amax
    aux = make_pipeline(p, mesh, False, int8="static", int8_aux="static")
    out["int8_aux"] = sample(aux, p, guidance_scale=7.5)
    out["aux_amax"] = aux.aux_amax
    return out


def random_batch(seed, bsz, length=16, side=32):
    """A pretraining batch of ``bsz`` rows with its draws (noise,
    timesteps, posterior noise), made with numpy."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 1000, (bsz, length))
    ph = np.arange(bsz) % 5 + 2
    ids[np.arange(bsz), ph] = 999
    lat = (bsz, 4, side // 2, side // 2)  # the tiny VAE halves the side
    return {
        "pixel_values": torch.from_numpy(
            rng.uniform(-1, 1, (bsz, 3, side, side)).astype(np.float32)),
        "input_ids": torch.from_numpy(ids).long(),
        "placeholder_idx": torch.from_numpy(ph).long(),
        "uncond_ids": torch.from_numpy(rng.integers(0, 1000, (1, length))),
        "class_token_id": torch.tensor(5),
        "noise": torch.from_numpy(
            rng.standard_normal(lat).astype(np.float32)),
        "timesteps": torch.from_numpy(rng.integers(0, 1000, (bsz,))),
        "posterior_noise": torch.from_numpy(
            rng.standard_normal(lat).astype(np.float32)),
    }
