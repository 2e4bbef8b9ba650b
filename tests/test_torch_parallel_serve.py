"""Multi-rank sampling in the port on the CPU (gloo, two spawned ranks): the
tp=2 UNet against one process and against the JAX UNet, a head-split
attention module forward and backward, in int8 and under E4T_FUSED_QKV,
and the sampling pipeline under data-parallel serving (DDIM,
Euler-ancestral, dynamic int8, a batch dp does not divide) and under tp=2
(f32, LoRA and calibrated int8).

The JAX UNet runs once, jitted, on the tiny weights the port carries over.
One spawn runs every multi-rank case (``torch_parallel_workers
.serve_cases``); the one-process references run here.

Tolerances, f32 on the CPU: the tp=2 UNet's eps and tap rel-L2 1e-4
against tp=1 and against JAX (the JAX package's
``tests/test_tensor_parallel.py``); the attention module's output and
gradients 1e-5 absolute (its head-sharded attention test); dp=2 images
1e-4 absolute against one rank (its ``tests/test_dp_serving.py``); the
int8 attention at tp=2 1e-5 relative to its output's range against tp=1
(the same int8 values, the row shards' f32 partial products summed in
another order); int8 "static" at tp=2: calibrated ranges to 1e-5 of each
range, and images whose int8 error against f32 is within 0.5-1.5x of one
process's (int8 images are compared by error size, as in
``tests/test_torch_pipeline.py``); int8 "static_pc" at tp=2 (per-channel
activation scales, held against one process as the JAX package's
``tests/test_dp_serving.py::test_static_act_int8_under_tp_mesh`` holds tp
against one device): the same range tolerance, each rank's q / s / sac
bit for bit the slices of tp=1's on the same ranges, and the same image
error ratio. The interactive server at dp=2 (``serve_e4t --interactive
--data_parallel_serving``; two prompts, a blank line and a refused prompt
on rank 0's standard input only): its PNGs within one level of 255 of
the one-process server's (each rank renders the prompt repeated over dp
at batch 1, one process the prompt alone).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from e4t_diffusion_tpu.utils import artifacts as jax_artifacts
from e4t_diffusion_torch.parallel import mesh as pmesh
from e4t_diffusion_torch.utils.tokenizer import make_tiny_tokenizer_files

import torch_parallel_workers as workers
from test_artifacts import _write_sd_base
from torch_parity import jax_tiny, port_tiny, rel_l2

UNET_TOL = 1e-4
ATTN_TOL = 1e-5
IMAGE_TOL = 1e-4
INT8_ATTN_TOL = 1e-5
E4T_CONFIG = {"placeholder_token": "*s", "domain_class_token": "face",
              "domain_embed_scale": 0.1}
# rank 0's standard input in the interactive case: two renders, a blank
# line skipped and a prompt without the placeholder refused on every rank
INTERACTIVE_LINES = ["a photo of *s", "", "a photo of a face", "a *s face"]


def _random_lora(unet_config):
    """A LoRA bank whose up projections are not zero (a fresh bank's are,
    which would fold nothing)."""
    from e4t_diffusion_torch.models import lora

    gen = torch.Generator().manual_seed(3)
    bank = lora.init_lora_bank(unet_config, generator=gen)
    for layers in bank.values():
        for layer in layers.values():
            layer["up"] = 0.1 * torch.randn(layer["up"].shape, generator=gen)
    return bank


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jm, params = jax_tiny(seed=5)
    _, sds = port_tiny(params)
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("serve")
    payload = {
        "sds": sds, "e4t_config": E4T_CONFIG,
        "tok_dir": make_tiny_tokenizer_files(
            str(root / "tok"), extra_words=["photo", "of", "a", "face"]),
        "prompts": ["a photo of *s", "a *s face"],
        "image": rng.uniform(0, 255, (32, 32, 3)).astype(np.uint8),
        "x": torch.from_numpy(rng.standard_normal((2, 4, 8, 8))
                              .astype(np.float32)),
        "t": torch.tensor([10, 500]),
        "ctx": torch.from_numpy(rng.standard_normal((2, 16, 32))
                                .astype(np.float32)),
        "attn_x": torch.from_numpy(rng.standard_normal((2, 64, 32))
                                   .astype(np.float32)),
        "attn_dout": torch.from_numpy(rng.standard_normal((2, 64, 32))
                                      .astype(np.float32)),
        "lora": _random_lora(jm.unet.config),
        "lines": INTERACTIVE_LINES, "root": str(root / "ranks")}
    payload.update(_artifact(root, jm, params))
    ranks = workers.run_ranks(workers.serve_cases, 2, payload, root / "run")
    torch.set_num_threads(1)
    one = workers.single_process_sampling(payload)
    one["interactive"] = workers.interactive(
        0, {**payload, "root": str(root / "one")})
    # tp=1's int8 sites on the ranges calibrated at tp=2 (every rank holds
    # the same ones)
    one["pc_sites_on_rank0_ranges"] = workers.unet_int8_sites(
        workers.make_pipeline(payload, pmesh.Mesh(), False,
                              int8="static_pc"),
        ranks[0]["tp_int8_pc_amax"])
    one["unet"] = workers.unet_forward(pmesh.Mesh(), payload)
    jax_eps, jax_tap = jax.jit(lambda p, x, t, c: jm.unet.apply(
        {"params": p}, x, t, c, return_encoder_outputs="with_eps"))(
        params["unet"], jnp.asarray(payload["x"].numpy()),
        jnp.asarray(payload["t"].numpy()),
        jnp.asarray(payload["ctx"].numpy()))
    one["jax"] = (np.asarray(jax_eps),
                  [np.transpose(np.asarray(t), (0, 3, 1, 2))
                   for t in jax_tap])
    return ranks, one


def _artifact(root, jm, params):
    """The tiny weights as a model directory (written by the JAX package's
    helpers, no compile) and a subject image, for the interactive server."""
    params = jax.tree_util.tree_map(np.asarray, params)
    sd_dir = _write_sd_base(str(root / "sd"), jm, params)
    make_tiny_tokenizer_files(os.path.join(sd_dir, "tokenizer"),
                              extra_words=["photo", "of", "a", "face"])
    artifact = jax_artifacts.save_e4t_weights(
        str(root / "art"), 1,
        dict(E4T_CONFIG, pretrained_model_name_or_path=sd_dir,
             vit_config="tiny"),
        params["e4t"], jm.e4t_encoder.config, offsets=params["offsets"])
    image = root / "in.png"
    Image.fromarray(np.random.default_rng(6).integers(
        0, 255, (40, 40, 3), dtype=np.uint8)).save(image)
    return {"artifact": artifact, "image_path": str(image)}


def test_tp2_unet_matches_tp1_and_jax(setup):
    ranks, one = setup
    jax_eps, jax_tap = one["jax"]
    for rank in ranks:
        got = rank["unet_tp2"]
        assert got["heads"] == 2 and one["unet"]["heads"] == 4
        assert rel_l2(got["eps"], one["unet"]["eps"]) <= UNET_TOL
        assert rel_l2(got["eps"], jax_eps) <= UNET_TOL
        for g, ref, j in zip(got["tap"], one["unet"]["tap"], jax_tap):
            assert rel_l2(g, ref) <= UNET_TOL
            assert rel_l2(g, j) <= UNET_TOL


def test_tp2_attention_forward_and_backward(setup):
    """Each rank's local heads: the output and the input's gradient equal
    one process's; each split weight's gradient is its shard of the whole
    gradient, the replicated bias's the whole one."""
    ranks, one = setup
    ref = one["unet"]
    for r, rank in enumerate(ranks):
        got = rank["unet_tp2"]
        torch.testing.assert_close(got["attn_out"], ref["attn_out"],
                                   rtol=0, atol=ATTN_TOL)
        torch.testing.assert_close(got["attn_dx"], ref["attn_dx"], rtol=0,
                                   atol=ATTN_TOL)
        for name, g in ref["attn_grads"].items():
            dim = {"to_q.weight": 0, "to_k.weight": 0, "to_v.weight": 0,
                   "to_out.0.weight": 1}.get(name)
            want = g if dim is None else g.chunk(2, dim=dim)[r]
            torch.testing.assert_close(got["attn_grads"][name], want,
                                       rtol=0, atol=ATTN_TOL)


def test_tp2_fused_qkv_matches_tp1(setup):
    """E4T_FUSED_QKV under tp=2: one product against the concatenated
    local shards of q/k/v (k/v for cross-attention)."""
    ranks, one = setup
    for rank in ranks:
        for got, ref in zip(rank["unet_tp2"]["fused_qkv"],
                            one["unet"]["fused_qkv"]):
            torch.testing.assert_close(got, ref, rtol=0, atol=ATTN_TOL)


def test_tp2_int8_attention_site_matches_tp1(setup):
    ranks, one = setup
    ref = one["unet"]["attn_int8"]
    span = float(ref.abs().max())
    for rank in ranks:
        got = rank["unet_tp2"]["attn_int8"]
        assert float((got - ref).abs().max()) <= INT8_ATTN_TOL * span


@pytest.mark.parametrize("case,ref", [("dp_ddim", "ddim"),
                                      ("dp_euler_a", "euler_a"),
                                      ("dp_int8", "int8"),
                                      ("tp_ddim", "ddim"),
                                      ("tp_lora", "lora")])
def test_parallel_sampling_gives_one_ranks_images(setup, case, ref):
    """dp=2 serving (each rank half the batch, the latents and
    Euler-ancestral's per-step noise drawn for the whole batch; int8 on
    scales MAX-reduced over the ranks) and tp=2 (LoRA deltas cut as their
    weights are): every rank returns the whole batch's images, those of
    one process."""
    ranks, one = setup
    for rank in ranks:
        assert rank[case].shape == one[ref].shape == (4, 3, 16, 16)
        assert np.abs(rank[case] - one[ref]).max() <= IMAGE_TOL


def test_tp2_int8_static_calibrates_and_serves_as_one_process(setup):
    ranks, one = setup
    want = one["int8_amax"]
    for rank in ranks:
        got = rank["tp_int8_amax"]
        assert set(got) == set(want)
        for name, site in want.items():
            for k, v in site.items():
                assert got[name][k].shape == v.shape, (name, k)
                torch.testing.assert_close(got[name][k], v, rtol=0,
                                           atol=1e-5 * float(v.max()))
        err = rel_l2(rank["tp_int8_static"], one["ddim"])
        one_err = rel_l2(one["int8_static"], one["ddim"])
        assert 1e-4 < one_err and 0.5 * one_err < err < 1.5 * one_err


def test_dp2_int8_towers_calibrate_as_one_process(setup):
    """int8 "static" with the towers in int8 under dp=2: each rank
    calibrates the ViT-H and the VAE decode on its rows, the ranges are
    MAX-reduced to one process's, and the images carry its int8 error."""
    ranks, one = setup
    for rank in ranks:
        for tower, sites in one["aux_amax"].items():
            got = rank["dp_aux_amax"][tower]
            assert set(got) == set(sites)
            for name, site in sites.items():
                for k, v in site.items():
                    torch.testing.assert_close(got[name][k], v, rtol=0,
                                               atol=1e-5 * float(v.max()))
        err = rel_l2(rank["dp_int8_aux"], one["ddim"])
        one_err = rel_l2(one["int8_aux"], one["ddim"])
        assert 1e-4 < one_err and 0.5 * one_err < err < 1.5 * one_err


def test_batch_dp_does_not_divide_raises(setup):
    ranks, _ = setup
    for rank in ranks:
        assert "batch (3)" in rank["indivisible"]
        assert "dp mesh axis (2)" in rank["indivisible"]


def test_tp2_int8_static_pc_serves_as_one_process(setup):
    """Per-channel static int8 under tp=2: the ranges calibrated at tp=2
    are one process's (the row sites' per-channel ranges gathered to the
    unsplit layout), each rank's sites are tp=1's on the same ranges cut
    by the weight split, bit for bit (a row site's sac its input columns'
    slice, a column site's whole), and the images carry one process's
    int8 error."""
    ranks, one = setup
    for rank in ranks:
        got = rank["tp_int8_pc_amax"]
        assert set(got) == set(one["int8_amax"])
        for name, site in one["int8_amax"].items():
            for k, v in site.items():
                assert got[name][k].shape == v.shape, (name, k)
                torch.testing.assert_close(got[name][k], v, rtol=0,
                                           atol=1e-5 * float(v.max()))
        err = rel_l2(rank["tp_int8_pc"], one["ddim"])
        one_err = rel_l2(one["int8_pc"], one["ddim"])
        assert 1e-4 < one_err and 0.5 * one_err < err < 1.5 * one_err
    whole = one["pc_sites_on_rank0_ranges"]
    specs = ranks[0]["tp_specs"]
    assert {k for k, v in specs.items() if v == "row"}
    row_sites = 0
    for r, rank in enumerate(ranks):
        sites = rank["tp_int8_pc_sites"]
        assert set(sites) == set(whole)
        for name, site in sites.items():
            kind = specs.get(f"{name}.weight")
            ref = whole[name]
            assert set(site) == set(ref) == {"q", "s", "sac"}, name
            if kind is None:
                want = ref
            elif kind == "row":
                row_sites += 1
                want = {"q": pmesh._split(ref["q"], kind, 2, r),
                        "s": ref["s"],
                        "sac": pmesh._split(ref["sac"][None], kind, 2,
                                            r)[0]}
            else:
                want = {"q": pmesh._split(ref["q"], kind, 2, r),
                        "s": pmesh._split(ref["s"], kind, 2, r),
                        "sac": ref["sac"]}
            for k in want:
                assert torch.equal(site[k], want[k]), (r, name, k)
    assert row_sites > 0


def test_interactive_server_at_dp2_gives_one_process_images(setup):
    """``serve_e4t --interactive --data_parallel_serving`` at world 2: rank
    0 alone read standard input and wrote the two images and the lines;
    the refused prompt hung no rank; the images are the one-process
    server's."""
    ranks, one = setup
    ref = one["interactive"]
    assert ref["files"] == ["interactive-0.png", "interactive-1.png"]
    got = ranks[0]["interactive"]
    assert got["files"] == ref["files"]
    for name, img in ref["images"].items():
        assert img.shape == (16, 16, 3)
        diff = np.abs(got["images"][name].astype(np.int16) - img)
        assert diff.max() <= 1, name
    assert sum("error:" in ln for ln in got["printed"]) == 1
    assert [ln.split()[0].rsplit(os.sep, 1)[-1] for ln in got["printed"]
            if ".png" in ln] == ref["files"]
    assert not [ln for ln in ranks[1]["interactive"]["printed"]
                if "interactive" in ln or "error:" in ln]


def test_interactive_prompts_outwait_the_world_groups_timeout(setup):
    """Rank 0 waits on standard input longer than the world group's
    timeout: the other rank, waiting for the line, is not aborted, and
    every rank gets every non-blank line in order (the broadcast goes over
    ``Mesh.patient_group``, not the world group)."""
    ranks, _ = setup
    timeout, delay = workers.PATIENT_CASE_S
    assert delay > 2 * timeout
    want = [ln.strip() for ln in INTERACTIVE_LINES if ln.strip()]
    assert want and [r["patient_prompts"] for r in ranks] == [want, want]
