"""The port's parallel layer in one process: torchrun's environment, the
one-process mesh, the flash routes on global shapes, the tensor-parallel
splits (the GEGLU halves, the int8 scales of a row shard), the loader's
per-rank split, data-parallel rows and the per-rank checkpoint state. The
multi-rank runs are in ``tests/test_torch_parallel_{train,serve}.py``."""
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from e4t_diffusion_torch.data.dataset import E4TDataLoader
from e4t_diffusion_torch.diffusion.pipeline import E4TModules
from e4t_diffusion_torch.models.unet import FeedForward
from e4t_diffusion_torch.ops import attention, quant
from e4t_diffusion_torch.ops.attention import (batch_shards, flash_attention,
                                               flash_route, shortseq_route)
from e4t_diffusion_torch.parallel import mesh as pmesh
from e4t_diffusion_torch.training import train_step as ts
from e4t_diffusion_torch.utils import artifacts

CUDA = torch.device("cuda")


@pytest.mark.parametrize("present", [("MASTER_ADDR", "RANK"),
                                     ("WORLD_SIZE", "LOCAL_RANK",
                                      "MASTER_PORT", "RANK")])
def test_half_set_torchrun_environment_raises(monkeypatch, present):
    """Some of torchrun's variables and not all: a RuntimeError naming the
    missing ones, never a one-process run."""
    for k in pmesh.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    for k in present:
        monkeypatch.setenv(k, "0")
    missing = [k for k in pmesh.TORCHRUN_ENV if k not in present]
    with pytest.raises(RuntimeError) as err:
        pmesh.maybe_initialize_distributed(torch.device("cpu"))
    for k in missing:
        assert k in str(err.value)
    assert not torch.distributed.is_initialized()


def test_without_torchrun_the_mesh_is_one_process(monkeypatch):
    for k in pmesh.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    cpu = torch.device("cpu")
    assert pmesh.maybe_initialize_distributed(cpu) == cpu
    mesh = pmesh.get_mesh()
    assert (mesh.dp, mesh.tp, mesh.rank, mesh.distributed) == (1, 1, 0, False)
    assert mesh.any_rank(True, cpu) and not mesh.any_rank(False, cpu)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        pmesh.get_mesh(tp=2)


# the 512px batch-8 run's 1024-token d80 self-attention: BH 64, 256 MiB of
# f32 scores; at dp=2 or tp=2 a rank holds BH 32, exactly 128 MiB
SITE_1024 = ((8, 8, 1024, 80), (8, 8, 1024, 80))


@pytest.mark.parametrize("dp,tp", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_flash_route_is_the_same_on_every_grid(dp, tp):
    (b, h, s, d), _ = SITE_1024
    local = (b // dp, h // tp, s, d)
    with batch_shards(dp):
        assert flash_route(local, local, CUDA, head_shards=tp)
        # a 256-token site stays on einsum at every grid
        small = (b // dp, h // tp, 256, 160)
        assert not flash_route(small, small, CUDA, head_shards=tp)
    if dp * tp > 1:  # the local shape alone would leave flash (the trap)
        assert not flash_route(local, local, CUDA)


def test_shortseq_route_counts_the_global_batch(monkeypatch):
    """The ViT-H's 257-token sites: routed on the global batch x heads,
    and only where the rank's own batch x heads is even."""
    monkeypatch.setenv("E4T_SHORTSEQ_MH_ATTN", "8")
    shape = (2, 16, 257, 80)
    with batch_shards(2):
        assert shortseq_route(shape, shape, CUDA)
        assert shortseq_route(shape, shape, CUDA, head_shards=2)
        assert not shortseq_route((1, 1, 257, 80), (1, 1, 257, 80), CUDA)


def test_tensor_parallel_specs_of_the_tiny_unet():
    unet = E4TModules.tiny(device="cpu").unet
    specs = pmesh.tensor_parallel_specs(unet, 2)
    kinds = {}
    for name, kind in specs.items():
        kinds.setdefault(kind, set()).add(name.split(".")[-2]
                                          if kind != "geglu" else "proj")
    assert kinds == {"col": {"to_q", "to_k", "to_v"}, "row": {"0", "2"},
                     "geglu": {"proj"}}
    n_attn = sum(1 for n in specs if n.endswith("to_q.weight"))
    assert n_attn == 8  # attn1 and attn2 of four transformer blocks
    assert not any("proj_in" in n or "proj_out" in n for n in specs)
    # tp=3 divides neither the 4 heads nor the feed-forward widths
    assert pmesh.tensor_parallel_specs(unet, 3) == {}
    assert pmesh.tensor_parallel_specs(unet, 1) == {}


def test_geglu_halves_split_each_on_its_own():
    """The GEGLU projection's rows are [hidden; gate]: a rank keeps its
    share of each, so its local GEGLU is its columns of the whole one, and
    the row-parallel partial products of net.2 sum to the whole output."""
    torch.manual_seed(0)
    ff = FeedForward(32)
    x = torch.randn(2, 5, 32)
    with torch.no_grad():
        whole_h = ff.net[0](x)
        whole = ff(x)
        proj = ff.net[0].proj
        inner = proj.out_features // 2
        partial = torch.zeros_like(whole)
        for rank in range(2):
            w = pmesh._split(proj.weight, "geglu", 2, rank)
            b = pmesh._split(proj.bias, "geglu", 2, rank)
            hidden, gate = F.linear(x, w, b).chunk(2, dim=-1)
            local = hidden * F.gelu(gate)
            cols = slice(rank * inner // 2, (rank + 1) * inner // 2)
            torch.testing.assert_close(local, whole_h[..., cols], rtol=0,
                                       atol=1e-6)
            w2 = pmesh._split(ff.net[2].weight, "row", 2, rank)
            partial += F.linear(local, w2)
        torch.testing.assert_close(partial + ff.net[2].bias, whole,
                                   rtol=0, atol=1e-5)
        # a contiguous cut would hand rank 0 all of hidden, rank 1 the gate
        joined = pmesh._join([pmesh._split(proj.weight, "geglu", 2, r)
                              for r in range(2)], "geglu")
        assert torch.equal(joined, proj.weight)


def test_head_split_flash_equals_the_whole_call():
    """Head-sharded attention (the JAX package's shard_map over heads): the
    flash call on each half of the heads, forward and backward, put back
    together equals the whole call (the CPU runs the kernels' plain
    versions)."""
    g = torch.Generator().manual_seed(0)
    q, k, v, dout = (torch.randn(2, 4, 130, 40, generator=g)
                     for _ in range(4))

    def run(q, k, v, dout):
        q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
        out = flash_attention(q, k, v)
        out.backward(dout)
        return out.detach(), q.grad, k.grad, v.grad

    whole = run(q, k, v, dout)
    halves = [run(*(t[:, r * 2:(r + 1) * 2] for t in (q, k, v, dout)))
              for r in range(2)]
    for i, ref in enumerate(whole):
        got = torch.cat([h[i] for h in halves], dim=1)
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)


def test_row_shard_int8_scales_are_the_whole_kernels():
    """quantize_params with a reducer: a row-parallel shard's per-output
    channel scales are those of the whole kernel, its int8 values the
    whole kernel's columns."""
    w = torch.randn(6, 8, generator=torch.Generator().manual_seed(1))
    whole = quant.quantize_kernel(w)
    shards = w.chunk(2, dim=1)
    amax = torch.stack([s.abs().amax(dim=1) for s in shards]).amax(0)
    for r, shard in enumerate(shards):
        site = quant.quantize_params(
            {"to_out.0.weight": shard},
            kernel_reduce=lambda name, a: torch.maximum(a, amax))["to_out.0"]
        assert torch.equal(site["s"], whole["s"])
        assert torch.equal(site["q"], whole["q"].chunk(2, dim=1)[r])


def test_row_shard_per_channel_scales_are_the_whole_vectors_slice():
    """static_pc under tp: quantize_params computes "sac" on the whole
    calibrated per-channel range, then a row-parallel site keeps the slice
    at its weight shard's input columns and a column-split site the whole
    vector (``mesh.channel_scale_shard``); each shard's q, s and sac are
    tp=1's slices, bit for bit."""
    import types

    gen = torch.Generator().manual_seed(2)
    weights = {"to_out.0.weight": torch.randn(6, 8, generator=gen),
               "to_q.weight": torch.randn(8, 6, generator=gen)}
    calib = {"to_out.0": {"amax": torch.tensor(3.0),
                          "amax_c": torch.rand(8, generator=gen) + 0.1},
             "to_q": {"amax": torch.tensor(2.0),
                      "amax_c": torch.rand(6, generator=gen) + 0.1}}
    kwargs = dict(act_amax=calib, act_pc=True, static_exclude=())
    whole = quant.quantize_params(weights, **kwargs)
    # the row site's per-output abs-max over both shards: the whole kernel's
    row_amax = (weights["to_out.0.weight"] * whole["to_out.0"]["sac"]
                ).abs().amax(dim=1)
    specs = {"to_out.0.weight": "row", "to_q.weight": "col"}
    for r in range(2):
        unet = types.SimpleNamespace(tp_specs=specs,
                                     tp_site=pmesh.TPGroup(None, 2, r))
        shard = quant.quantize_params(
            {k: pmesh.local_shard(unet, k, w) for k, w in weights.items()},
            kernel_reduce=lambda name, a: (torch.maximum(a, row_amax)
                                           if name == "to_out.0" else a),
            act_shard=pmesh.channel_scale_shard(unet), **kwargs)
        row, col = shard["to_out.0"], shard["to_q"]
        assert torch.equal(row["sac"], whole["to_out.0"]["sac"].chunk(2)[r])
        assert torch.equal(row["q"], whole["to_out.0"]["q"].chunk(
            2, dim=1)[r])
        assert torch.equal(row["s"], whole["to_out.0"]["s"])
        assert torch.equal(col["sac"], whole["to_q"]["sac"])
        assert torch.equal(col["q"], whole["to_q"]["q"].chunk(2)[r])
        assert torch.equal(col["s"], whole["to_q"]["s"].chunk(2)[r])
    assert pmesh.channel_scale_shard(torch.nn.Linear(2, 2)) is None


def _images(n):
    rng = np.random.default_rng(0)
    return [Image.fromarray(rng.integers(0, 255, (12, 12, 3), dtype=np.uint8))
            for _ in range(n)]


def _source(kind, tmp_path, monkeypatch):
    """Seven images as an image folder or as an HF dataset (streamed or
    not; ``load_dataset`` patched to build it here, with no download)."""
    images = _images(7)
    if kind == "folder":
        os.makedirs(tmp_path / "d")
        for i, img in enumerate(images):
            img.save(tmp_path / "d" / f"{i}.png")
        return str(tmp_path / "d"), False
    import datasets

    def load_dataset(name, split, streaming):
        ds = datasets.Dataset.from_dict({"image": images})
        return ds.to_iterable_dataset() if streaming else ds

    monkeypatch.setattr(datasets, "load_dataset", load_dataset)
    return "local/faces", kind == "hf_streaming"


@pytest.mark.parametrize("kind", ["folder", "hf", "hf_streaming"])
def test_loader_gives_each_rank_its_own_images(kind, tmp_path, monkeypatch):
    """At world 2: at every step the ranks' batches, in rank order, are the
    images of the one-process loader's batch at twice the batch size
    (across passes over the data); within one pass no image is read by
    both ranks."""
    source, streaming = _source(kind, tmp_path, monkeypatch)
    kw = dict(resolution=8, random_crop=False, seed=3, streaming=streaming)
    one = iter(E4TDataLoader(source, 4, process_index=0, process_count=1,
                             **kw))
    ranks = [iter(E4TDataLoader(source, 2, process_index=r, process_count=2,
                                **kw)) for r in range(2)]
    for step in range(5):  # 20 samples: three passes over 7 images
        want = next(one)["pixel_values"]
        got = [next(it)["pixel_values"] for it in ranks]
        # the same images; each process draws its own random flips
        for g, w in zip(np.concatenate(got), want):
            assert (np.array_equal(g, w)
                    or np.array_equal(g, w[:, :, ::-1])), step
        if step == 0:  # the first pass: disjoint
            a, b = ({x.tobytes() for x in g} for g in got)
            assert len(a | b) == 4


def test_rows_and_local_batch():
    mesh = pmesh.Mesh(dp=2, tp=2, rank=3)
    assert (mesh.dp_rank, mesh.tp_rank, mesh.world) == (1, 1, 4)
    assert mesh.rows(8) == slice(4, 8)
    assert pmesh.local_batch_slice(8, mesh) == 4
    with pytest.raises(ValueError, match=r"dp mesh axis \(2\)"):
        mesh.rows(3)
    with pytest.raises(ValueError, match=r"batch \(3\) not divisible"):
        pmesh.local_batch_slice(3, mesh)
    batch = {"x": torch.arange(4), "one": torch.tensor(5),
             "odd": torch.arange(3)}
    shard = pmesh.shard_batch(batch, pmesh.Mesh(dp=2, rank=1))
    assert shard["x"].tolist() == [2, 3] and int(shard["one"]) == 5
    assert shard["odd"].tolist() == [0, 1, 2]


def test_checkpoint_keeps_generators_by_rank(tmp_path):
    """One process: the file holds its generator state in a list of one;
    a checkpoint without that list (written before it) restores rank 0's,
    and a rank it has no state for keeps its own."""
    p = torch.zeros(3, requires_grad=True)
    trainable = {"g": {"p": p}}
    opt = ts.make_optimizer([p], 1e-3)
    p.grad = torch.ones(3)
    opt.step()
    gen = torch.Generator().manual_seed(5)
    torch.randn(2, generator=gen)
    path = artifacts.save_train_state(str(tmp_path), 1, trainable, opt, 1,
                                      gen)
    payload = torch.load(os.path.join(path, artifacts.TRAIN_STATE_FILE),
                         weights_only=True)
    assert len(payload["generators"]) == 1
    assert torch.equal(payload["generators"][0], gen.get_state())
    fresh = torch.Generator().manual_seed(9)
    state = fresh.get_state()
    artifacts.restore_train_state(path, trainable, opt, fresh, rank=1)
    assert torch.equal(fresh.get_state(), state)
    payload["generator"] = payload.pop("generators")[0]  # the old layout
    torch.save(payload, os.path.join(path, artifacts.TRAIN_STATE_FILE))
    artifacts.restore_train_state(path, trainable, opt, fresh, rank=0)
    assert torch.equal(fresh.get_state(), gen.get_state())


def test_tracker_without_tensorboardx_logs_nothing(monkeypatch, tmp_path):
    """A machine without tensorboardX (the card's) still runs the training
    CLIs: --report_to tensorboard (and wandb's fallback) log nothing."""
    import builtins

    from e4t_diffusion_torch.utils import trackers

    real = builtins.__import__

    def no_tensorboardx(name, *args, **kwargs):
        if name.split(".")[0] in ("tensorboardX", "wandb"):
            raise ImportError(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tensorboardx)
    for report_to in ("tensorboard", "wandb"):
        tracker = trackers.make_tracker(report_to, str(tmp_path / "logs"))
        assert type(tracker) is trackers.NullTracker
        tracker.log({"loss": 1.0}, 1)
    assert not (tmp_path / "logs").exists()


def test_routes_leave_attention_unchanged_on_the_cpu():
    """The CPU never routes to a kernel, whatever the grid."""
    with batch_shards(4):
        assert not attention.flash_route(*SITE_1024, torch.device("cpu"))


def test_row_partial_product_keeps_f32_from_bf16_operands():
    """A row-parallel site's partial product from bf16 operands comes out
    in f32, unrounded (the CPU multiplies f32 copies; the card keeps
    cuBLAS's f32 accumulator), and its backward is F.linear's in bf16."""
    g = torch.Generator().manual_seed(0)
    lin = quant.Linear(48, 24).to(torch.bfloat16)
    x = torch.randn(2, 7, 48, generator=g).to(torch.bfloat16)
    dout = torch.randn(2, 7, 24, generator=g)
    xa = x.clone().requires_grad_(True)
    y = quant.linear_partial(lin, xa)
    assert y.dtype == torch.float32
    assert torch.equal(y, F.linear(x.float(), lin.weight.float()))
    y.backward(dout.bfloat16().float())
    xb = x.clone().requires_grad_(True)
    F.linear(xb, lin.weight).backward(dout.bfloat16())
    torch.testing.assert_close(xa.grad, xb.grad, rtol=0, atol=0)
    # f32 operands: F.linear itself
    x32 = x.float()
    assert torch.equal(quant.linear_partial(lin.float(), x32),
                       F.linear(x32, lin.weight))
