"""The port's int8 serving (ops/quant.py, the UNet's int8 sites, the
calibration run and the act-scales files) against the JAX package's, on the
CPU, on the tiny configs with numpy-seeded weights carried by
``state_dicts_from_jax``.

The int8 arithmetic is exact on both sides (int32 products, the same f32
rescale), so a site fed the same input gives the same output. Across a
whole network two f32 implementations differ by ulps, and an ulp that moves
a value across a rounding boundary of the int8 grid changes that value by
one quantization step; downstream sites then see a perturbation far above
an ulp and round differently in turn. So the UNet is compared site by site
on the JAX run's own inputs, and end to end only for the size of its error.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from e4t_diffusion_tpu.diffusion.pipeline import (
    make_calibration_fn as jax_make_calibration_fn)
from e4t_diffusion_tpu.diffusion.schedulers import (
    DDIMScheduler as JaxDDIMScheduler)
from e4t_diffusion_tpu.models.clip_text import embed_tokens
from e4t_diffusion_tpu.ops import quant as jq

from e4t_diffusion_torch.diffusion import pipeline as port_pipeline
from e4t_diffusion_torch.diffusion.schedulers import DDIMScheduler
from e4t_diffusion_torch.ops import int8_conv as ic
from e4t_diffusion_torch.ops import quant

from torch_parity import jax_tiny, port_tiny, rel_l2


def _walk(tree, path=()):
    """(path, leaf dict) of every quantized kernel / calibrated site."""
    for k, v in tree.items():
        if k == "kernel" and jq.is_quantized(v):
            yield path, v
        elif isinstance(v, dict) and ("amax" in v or "amax_c" in v):
            yield path + (k,), v
        elif isinstance(v, dict):
            yield from _walk(v, path + (k,))


def amax_from_jax(tree):
    """A JAX calib tree -> the port's {module name: {"amax", "amax_c"}}."""
    return {quant.module_name(p): {k: torch.from_numpy(np.array(v))
                                   for k, v in site.items()}
            for p, site in _walk(tree)}


def sites_from_jax(qtree):
    """A JAX quantize_params tree -> the port's quantized sites (kernels
    transposed to (O, I) and (O, kh, kw, I))."""
    out = {}
    for path, v in _walk(qtree):
        q = np.asarray(v["q"])
        q = q.T if q.ndim == 2 else q.transpose(3, 0, 1, 2)
        site = {k: torch.from_numpy(np.array(x)) for k, x in v.items()
                if k != "q"}
        site["q"] = torch.from_numpy(np.ascontiguousarray(q))
        out[quant.module_name(path)] = site
    return out


@pytest.fixture(scope="module")
def world():
    """Tiny JAX and port UNets on the same weights, one input, and both
    packages' activation ranges recorded on it."""
    jm, params = jax_tiny(seed=1)
    modules, _ = port_tiny(params)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    t = np.array([5, 100], np.int32)
    ctx = rng.standard_normal((2, 16, 32)).astype(np.float32)
    with jq.calibration_trace():
        _, cvars = jax.jit(lambda p, *a: jm.unet.apply(
            {"params": p}, *a, mutable=["calib"]))(
                params["unet"], x, t, ctx)
    f32 = jax.jit(lambda p, *a: jm.unet.apply({"params": p}, *a))(
        params["unet"], x, t, ctx)
    with quant.calibration(modules.unet) as amax, torch.no_grad():
        modules.unet(*map(torch.from_numpy, (x, t, ctx)))
    return dict(jm=jm, params=params, modules=modules, inputs=(x, t, ctx),
                jax_amax=cvars["calib"], amax=amax, f32=np.asarray(f32))


@pytest.mark.parametrize("shape", [(48, 32), (16, 8, 3, 3)])
def test_quantize_kernel_matches_jax(shape):
    w = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    w[0] = 0.0  # an all-zero output channel takes the 1e-8 floor
    jax_w = w.T if w.ndim == 2 else w.transpose(2, 3, 1, 0)
    ref = jq.quantize_kernel(jnp.asarray(jax_w))
    got = quant.quantize_kernel(torch.from_numpy(w))
    ref_q = np.asarray(ref["q"])
    ref_q = ref_q.T if w.ndim == 2 else ref_q.transpose(3, 2, 0, 1)
    np.testing.assert_array_equal(got["q"].numpy(), ref_q)
    np.testing.assert_allclose(got["s"].numpy(), np.asarray(ref["s"]),
                               rtol=1e-7)


@pytest.mark.parametrize("env", [
    {},                                                # the defaults
    {"E4T_INT8_EXCLUDE": ""},                          # quantize every site
    {"E4T_INT8_EXCLUDE": "down_blocks_0,net_2,to_out_0"},
    {"E4T_INT8_STATIC_EXCLUDE": ""},
    {"E4T_INT8_STATIC_EXCLUDE": "attn1,resnets_1/conv2,upsamplers"},
    {"E4T_INT8_ACT_PC": "1"},
])
def test_site_sets_match_jax(world, monkeypatch, env):
    """Which sites are quantized, and which of them get a static scale (per
    tensor or per channel), under the default, empty and overridden
    exclusions, written with JAX module names."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    unet = world["modules"].unet
    for static in (False, True):
        jax_amax = world["jax_amax"] if static else None
        amax = world["amax"] if static else None
        ref = {quant.module_name(p): sorted(v)
               for p, v in _walk(jq.quantize_params(world["params"]["unet"],
                                                    act_amax=jax_amax))}
        got = {name: sorted(site) for name, site in quant.quantize_params(
            dict(unet.named_parameters()), act_amax=amax).items()}
        assert got == ref
        assert len(got) > 10


@pytest.mark.parametrize("act_pc", [False, True])
def test_static_scales_match_jax(world, act_pc):
    """"sa" and "sac" from one amax tree, as JAX's quantize_params sets
    them."""
    unet = world["modules"].unet
    ref = sites_from_jax(jq.quantize_params(
        world["params"]["unet"], act_amax=world["jax_amax"], act_pc=act_pc,
        static_exclude=()))
    got = quant.quantize_params(dict(unet.named_parameters()),
                                act_amax=amax_from_jax(world["jax_amax"]),
                                act_pc=act_pc, static_exclude=())
    key = "sac" if act_pc else "sa"
    assert set(got) == set(ref)
    assert all(key in site for site in got.values())
    for name, site in got.items():
        np.testing.assert_allclose(site[key].numpy(), ref[name][key].numpy(),
                                   rtol=1e-6, err_msg=name)


def _calib(x, axes):
    a = np.abs(x)
    return {"amax": jnp.float32(a.max() * 0.8),
            "amax_c": jnp.asarray(a.max(axis=axes) * 0.8)}


@pytest.mark.parametrize("mode", ["dynamic", "sa", "sac"])
@pytest.mark.parametrize("kind,stride,pad", [
    ("linear", 1, 0), ("conv3", 1, 1), ("conv3", 2, 1), ("conv1", 1, 0)])
def test_int8_ops_match_jax(kind, stride, pad, mode):
    """int8_linear / int8_conv2d against quant.int8_dense / quant.int8_conv
    on the same weights and scales: the int32 sums are exact, and the
    outputs agree to f32 rounding of the rescale (measured 0 or 1 ulp)."""
    rng = np.random.default_rng(4)
    if kind == "linear":
        x = rng.standard_normal((2, 40, 32)).astype(np.float32)
        w = (rng.standard_normal((32, 48)) / 6).astype(np.float32)
        axes = (0, 1)
    else:
        k = 3 if kind == "conv3" else 1
        x = rng.standard_normal((2, 9, 7, 32)).astype(np.float32)  # NHWC
        w = (rng.standard_normal((k, k, 32, 48)) / 17).astype(np.float32)
        axes = (0, 1, 2)
    calib = None if mode == "dynamic" else {"s": _calib(x, axes)}
    jk = jq.quantize_params({"s": {"kernel": jnp.asarray(w)}}, act_amax=calib,
                            act_pc=mode == "sac", exclude=(),
                            static_exclude=())["s"]["kernel"]
    site = sites_from_jax({"s": {"kernel": jk}})["s"]
    bias = rng.standard_normal(48).astype(np.float32)
    if kind == "linear":
        ref = np.asarray(jq.int8_dense(jnp.asarray(x), jk, jnp.float32))
        got = quant.int8_linear(torch.from_numpy(x), site, None).numpy()
        xq, _ = jq._quantize_activation(jnp.asarray(x), jk)
        acc = jax.lax.dot_general(xq, jk["q"], (((2,), (0,)), ((), ())),
                                  preferred_element_type=jnp.int32)
        got_acc = quant._int_mm(torch.from_numpy(np.asarray(xq)).reshape(
            -1, 32), site["q"]).reshape(2, 40, 48)
        np.testing.assert_array_equal(got_acc.numpy(), np.asarray(acc))
        # the bias is added in the output type after the rescale
        with_bias = quant.int8_linear(torch.from_numpy(x), site,
                                      torch.from_numpy(bias)).numpy()
        np.testing.assert_array_equal(with_bias, got + bias)
    else:
        pads = ((pad, pad), (pad, pad))
        ref = np.asarray(jq.int8_conv(jnp.asarray(x), jk, (stride, stride),
                                      pads, jnp.float32)).transpose(0, 3, 1, 2)
        got = quant.int8_conv2d(torch.from_numpy(x.transpose(0, 3, 1, 2)),
                                site, None, stride, pad).numpy()
        xq, _ = jq._quantize_activation(jnp.asarray(x), jk)
        acc = jax.lax.conv_general_dilated(
            xq, jk["q"], (stride, stride), pads,
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32)
        got_acc = ic.int8_conv_reference(
            torch.from_numpy(np.asarray(xq)), site["q"],
            torch.ones(48), None, torch.float64, stride, pad)
        np.testing.assert_array_equal(got_acc.numpy(),
                                      np.asarray(acc).transpose(0, 3, 1, 2))
        with_bias = quant.int8_conv2d(
            torch.from_numpy(x.transpose(0, 3, 1, 2)), site,
            torch.from_numpy(bias), stride, pad).numpy()
        np.testing.assert_array_equal(with_bias,
                                      got + bias[None, :, None, None])
    assert rel_l2(got, ref) <= 1e-6


def _jax_site_calls(jm, qparams, inputs):
    """The JAX UNet on ``qparams``; every quant.Dense / quant.Conv call's
    (input, output), keyed by the port's module name."""

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if (isinstance(context.module, (jq.Dense, jq.Conv))
                and context.method_name == "__call__"):
            context.module.sow("intermediates", "io", (args[0], out))
        return out

    def run(p, *a):
        with nn.intercept_methods(interceptor):
            return jm.unet.apply({"params": p}, *a,
                                 mutable=["intermediates"])

    y, inter = jax.jit(run)(qparams, *inputs)
    calls = {}

    def walk(node, path):
        for k, v in node.items():
            if k == "io":
                calls[quant.module_name(path)] = [
                    (np.asarray(i), np.asarray(o)) for i, o in v]
            else:
                walk(v, path + (k,))

    walk(inter["intermediates"], ())
    return np.asarray(y), calls


@pytest.mark.parametrize("mode", ["dynamic", "static", "static_pc"])
def test_unet_int8_matches_jax(world, mode):
    """The tiny UNet under each int8 mode on JAX's quantized params: every
    site of the port, fed the input its JAX counterpart saw in the JAX
    UNet's run, gives that site's output (int8 sites exactly; the excluded
    f32 sites to f32 rounding); end to end the port's int8 error against the
    f32 UNet is the size of JAX's."""
    jm, unet = world["jm"], world["modules"].unet
    static = mode != "dynamic"
    qparams = jq.quantize_params(
        world["params"]["unet"],
        act_amax=world["jax_amax"] if static else None,
        act_pc=mode == "static_pc",
        static_exclude=port_pipeline._static_exclude_for(
            mode == "static_pc") if static else None)
    sites = sites_from_jax(qparams)
    ref, calls = _jax_site_calls(jm, qparams, world["inputs"])
    assert set(calls) == set(quant.site_modules(unet))
    with quant.int8_sites(unet, sites), torch.no_grad():
        for name, ios in calls.items():
            module = unet.get_submodule(name)
            for x, y in ios:
                conv = x.ndim == 4
                xt = torch.from_numpy(x.transpose(0, 3, 1, 2) if conv else x)
                got = module(xt.contiguous()).numpy()
                want = y.transpose(0, 3, 1, 2) if conv else y
                # f32 convolutions at the excluded sites: summation order
                tol = 1e-6 if name in sites else 1e-5
                assert rel_l2(got, want) <= tol, name
        out = unet(*map(torch.from_numpy, world["inputs"])).numpy()
    jax_err, port_err = rel_l2(ref, world["f32"]), rel_l2(out, world["f32"])
    assert 0.005 < jax_err < 0.1
    assert 0.5 * jax_err < port_err < 1.5 * jax_err


def _calib_inputs(jm, params, batch):
    """Inputs for one calibration run, as numpy arrays."""
    rng = np.random.default_rng(7)
    length = jm.text_encoder.config.max_position_embeddings
    ids = np.zeros((1, length), np.int32)
    ids[0, 3] = 7
    embeds = np.asarray(embed_tokens(params["text"], jnp.asarray(ids)))
    class_embed = np.asarray(embed_tokens(params["text"],
                                          jnp.asarray([[5]]))[0, 0])
    return (rng.standard_normal((batch, 4, 8, 8)).astype(np.float32),
            rng.uniform(-1, 1, (1, 3, 32, 32)).astype(np.float32), embeds,
            np.full((batch,), 3, np.int32), np.zeros((1, length), np.int32),
            class_embed)


def test_calibration_matches_jax(world):
    """make_calibration_fn without CFG: the running max over the tap-only
    pass (which exits after the mid block) and the cond pass of every step,
    as JAX's, to 1e-5 of each site's range (three f32 steps of
    summation-order drift). tests/test_torch_pipeline.py holds the CFG
    calibration of the pipeline's first call against JAX."""
    guidance = 1.0
    jm, params, modules = world["jm"], world["params"], world["modules"]
    inputs = _calib_inputs(jm, params, 2)
    ref = jax_make_calibration_fn(jm, JaxDDIMScheduler(), 3, guidance, 0.1)(
        params["unet"], params["offsets"], params["text"], params["e4t"],
        *map(jnp.asarray, inputs), jax.random.PRNGKey(0))
    ref = amax_from_jax(jax.device_get(ref))
    _, sds = port_tiny(params)
    got = port_pipeline.make_calibration_fn(
        modules, DDIMScheduler(), 3, guidance, 0.1)(
            sds["offsets"], *[torch.from_numpy(a).long() if a.dtype == np.int32
                              else torch.from_numpy(a) for a in inputs])
    assert set(got) == set(ref) == set(quant.site_modules(modules.unet))
    for name, site in ref.items():
        for k, v in site.items():
            assert v.max() > 0, name
            np.testing.assert_allclose(got[name][k].numpy(), v.numpy(),
                                       rtol=0, atol=1e-5 * float(v.max()),
                                       err_msg=f"{name} {k}")


def test_act_scales_files_interoperate(world, tmp_path):
    """A file written by the JAX package loads in the port, one written by
    the port loads in JAX, to the same values; other formats are
    refused."""
    jax_file, port_file = tmp_path / "jax.json", tmp_path / "port.json"
    jq.save_act_scales(jax.device_get(world["jax_amax"]), str(jax_file))
    loaded = quant.load_act_scales(str(jax_file))
    want = amax_from_jax(world["jax_amax"])
    assert set(loaded) == set(want)
    for name, site in want.items():
        for k, v in site.items():
            assert torch.equal(loaded[name][k], v), name

    quant.save_act_scales(loaded, str(port_file))
    back = jq.load_act_scales(str(port_file))
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, v in jax.tree_util.tree_leaves_with_path(world["jax_amax"]):
        np.testing.assert_array_equal(np.asarray(flat[path]), np.asarray(v))
    assert len(flat) == len(jax.tree_util.tree_leaves(world["jax_amax"]))

    payload = json.loads(port_file.read_text())
    payload["format"] = "bogus"
    port_file.write_text(json.dumps(payload))
    with pytest.raises(ValueError, match="e4t-act-amax-v1"):
        quant.load_act_scales(str(port_file))


def test_module_names_round_trip(world):
    """Every int8-capable site of the UNet maps to a JAX module path that
    maps back, through utils/convert's component mapping."""
    for name in quant.site_modules(world["modules"].unet):
        assert quant.module_name(quant.jax_path(name).split("/")) == name
    assert (quant.jax_path("up_blocks.1.attentions.0.transformer_blocks.0"
                           ".ff.net.0.proj")
            == "up_blocks_1/attentions_0/transformer_blocks_0/ff/net_0_proj")


def test_serving_modes_match_jax(monkeypatch):
    """_static_exclude_for and _serving_int8_mode: the JAX package's
    serving defaults and their env overrides."""
    from e4t_diffusion_tpu.diffusion import pipeline as jax_pipeline

    for env in ({}, {"E4T_INT8_STATIC_EXCLUDE": "x"},
                {"E4T_INT8_ACT_PC": "1"}, {"E4T_INT8_ACT_PC": "0"}):
        for k in ("E4T_INT8_STATIC_EXCLUDE", "E4T_INT8_ACT_PC"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for pc in (False, True):
            assert (port_pipeline._static_exclude_for(pc)
                    == jax_pipeline._static_exclude_for(None, act_pc=pc))
        for mode in (False, True, "static", "static_pc"):
            assert (port_pipeline._serving_int8_mode(mode)
                    == jax_pipeline._serving_int8_mode(mode, 8, 512, 512))
