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
``tests/test_torch_pipeline.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e4t_diffusion_torch.parallel import mesh as pmesh
from e4t_diffusion_torch.utils.tokenizer import make_tiny_tokenizer_files

import torch_parallel_workers as workers
from torch_parity import jax_tiny, port_tiny, rel_l2

UNET_TOL = 1e-4
ATTN_TOL = 1e-5
IMAGE_TOL = 1e-4
INT8_ATTN_TOL = 1e-5
E4T_CONFIG = {"placeholder_token": "*s", "domain_class_token": "face",
              "domain_embed_scale": 0.1}


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
        "lora": _random_lora(jm.unet.config)}
    ranks = workers.run_ranks(workers.serve_cases, 2, payload, root / "run")
    torch.set_num_threads(1)
    one = workers.single_process_sampling(payload)
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
