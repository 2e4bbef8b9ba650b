"""The port's 8-bit AdamW (``training/optim8bit.py``) against the JAX
package's (``e4t_diffusion_tpu/training/optim8bit.py``), on the CPU.

The same seeded numpy inputs go through both. Quantization: the scales
equal exactly (a max and a select), and the codes equal but where the two
libraries' log10 round a value at a code's boundary the other way: the
share of such codes, each off by one, is bounded by ``TIE_SHARE`` (0 seen
so far) and none is off by more; dequantized values differ by the two
pow implementations, a few f32 ulp, well inside one code step. AdamW8bit:
five updates, the parameters' updates within rel-L2 ``UPDATE_TOL`` per
tensor (5.9e-5 measured: a few ulp in the bias corrections and codebooks);
the codes after them differ in at most ``TIE_SHARE`` of the places (1.0e-5
measured): a code rounded the other way at a tie changes that element's
later moments, so a few of those differ by more than one code (18 at most
seen, a mu near 0). JAX's update runs jitted, one small program (no
train-step compile).
"""
import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from e4t_diffusion_tpu.training import optim8bit as jax8

from e4t_diffusion_torch.ops import adam8bit as kernel
from e4t_diffusion_torch.training import optim8bit as o8

TIE_SHARE = 1e-3
UPDATE_TOL = 1e-3
# one code step, relative: signed codes span 7 decades in 126 steps,
# unsigned ones in 254
CODE_STEP = {True: 10 ** (7 / 126) - 1, False: 10 ** (7 / 254) - 1}
SHAPES = [(7,), (512, 512), (4096 * 256 + 300,)]  # the last: > 4096 blocks


def _values(case, rng):
    if case == "n1000":
        return rng.standard_normal(1000)
    if case == "blocks3":
        return rng.standard_normal(256 * 3)
    if case == "n257":
        return rng.standard_normal(257)
    if case == "zero_block":
        return np.concatenate([np.zeros(256), rng.standard_normal(300)])
    # magnitudes over 10 decades: past the codebooks' 7
    return np.sign(rng.standard_normal(5000)) * 10 ** rng.uniform(-10, 0, 5000)


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("case", ["n1000", "blocks3", "n257", "zero_block",
                                  "decades10"])
def test_quantize_matches_jax(case, signed):
    x = _values(case, np.random.default_rng(len(case))).astype(np.float32)
    if not signed:
        x = np.abs(x)
    want = jax8._quantize(jnp.asarray(x), 256, signed)
    q, scale = o8._quantize(torch.from_numpy(x), 256, signed)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    assert q.shape == want.q.shape and scale.shape == (want.q.shape[0],)
    np.testing.assert_array_equal(scale.numpy(),
                                  np.asarray(want.scale)[:, 0])
    off = np.abs(q.numpy().astype(int) - np.asarray(want.q).astype(int))
    assert off.max() <= 1
    assert (off > 0).mean() <= TIE_SHARE
    if case == "zero_block":
        assert scale[0] == 1.0 and (q[0] == (0 if signed else -128)).all()
    back = o8._dequantize(q, scale, x.shape, signed).numpy()
    ref = np.asarray(jax8._dequantize(want, x.shape, signed))
    assert np.all(np.abs(back - ref) <= CODE_STEP[signed] * np.abs(ref)
                  + 1e-38)
    same = off.reshape(-1)[:x.size] == 0
    np.testing.assert_allclose(back[same], ref[same], rtol=1e-6)


def _five_updates(seed=0, steps=5, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(1e-2 * rng.standard_normal(s)).astype(np.float32)
              for s in shapes] for _ in range(steps)]
    return params, grads


def _torch_run(params, grads, steps=None):
    tensors = [torch.from_numpy(p.copy()) for p in params]
    opt = o8.AdamW8bit(tensors, lr=1e-3)
    for g in grads[:steps]:
        for t, gi in zip(tensors, g):
            t.grad = torch.from_numpy(gi)
        opt.step()
    return tensors, opt


def test_adamw8bit_matches_jax_over_five_updates():
    params, grads = _five_updates()
    tx = jax8.adamw_8bit(1e-3)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    update = jax.jit(tx.update)
    for g in grads:
        u, state = update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, u)
    got, opt = _torch_run(params, grads)
    for p0, want, t in zip(params, jp, got):
        want, t = np.asarray(want) - p0, t.numpy() - p0
        assert np.linalg.norm(t - want) <= UPDATE_TOL * np.linalg.norm(want)
    adam = state[0]
    for p, mu, nu in zip(got, adam.mu, adam.nu):
        st = opt.state[p]
        assert st["step"] == int(adam.count) == 5
        for key, ref in (("mu", mu), ("nu", nu)):
            off = np.abs(st[f"{key}_q"].numpy().astype(int)
                         - np.asarray(ref.q).astype(int))
            assert (off > 0).mean() <= TIE_SHARE


def test_adamw8bit_tracks_fp32_adamw_on_a_quadratic():
    """The JAX package's quadratic test against torch's f32 AdamW at
    optax.adamw's defaults (weight decay 1e-4)."""
    target = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 64)).astype(np.float32))

    def run(opt_cls, **kw):
        p = torch.zeros_like(target, requires_grad=True)
        opt = opt_cls([p], lr=1e-2, **kw)
        for _ in range(60):
            opt.zero_grad()
            torch.mean((p - target) ** 2).backward()
            opt.step()
        return p.detach()

    p8 = run(o8.AdamW8bit)
    p32 = run(torch.optim.AdamW, weight_decay=1e-4)
    assert torch.mean((p8 - target) ** 2) < 0.5 * torch.mean(target ** 2)
    torch.testing.assert_close(p8, p32, atol=1e-1, rtol=0)


def test_state_is_int8_codes_and_block_scales():
    params, grads = _five_updates(steps=1)
    tensors, opt = _torch_run(params, grads)
    for t in tensors:
        st = opt.state[t]
        nb = -(-t.numel() // 256)
        assert (st["mu_q"].dtype, st["nu_q"].dtype) == (torch.int8,
                                                        torch.int8)
        assert st["mu_q"].shape == st["nu_q"].shape == (nb, 256)
        assert st["mu_scale"].shape == st["nu_scale"].shape == (nb,)
    big = tensors[1:]
    per_element = sum(
        v.numel() * v.element_size() for t in big
        for v in opt.state[t].values() if isinstance(v, torch.Tensor)
    ) / sum(t.numel() for t in big)
    assert per_element <= 2.04
    assert o8.state_bytes(opt) == sum(
        2 * (-(-t.numel() // 256)) * (256 + 4) for t in tensors)


def test_state_dict_save_load_and_continue_is_bit_for_bit():
    params, grads = _five_updates(seed=3, shapes=SHAPES[:2])
    whole, whole_opt = _torch_run(params, grads)
    first, first_opt = _torch_run(params, grads, steps=3)
    buf = io.BytesIO()
    torch.save(first_opt.state_dict(), buf)
    buf.seek(0)
    saved = torch.load(buf, weights_only=True)
    tensors = [t.detach().clone() for t in first]
    opt = o8.AdamW8bit(tensors, lr=1e-3)
    opt.load_state_dict(saved)
    for a, b in zip(tensors, first):
        for k, v in first_opt.state[b].items():
            got = opt.state[a][k]
            assert (got == v) if k == "step" else (
                got.dtype == v.dtype and torch.equal(got, v)), k
    for g in grads[3:]:
        for t, gi in zip(tensors, g):
            t.grad = torch.from_numpy(gi)
        opt.step()
    for a, b in zip(tensors, whole):
        assert torch.equal(a, b)
        for k, v in whole_opt.state[b].items():
            assert (opt.state[a][k] == v) if k == "step" else torch.equal(
                opt.state[a][k], v), k


@pytest.mark.parametrize("key,bad", [
    ("mu_q", lambda t: t[:-1]), ("nu_q", lambda t: t.reshape(-1)),
    ("mu_scale", lambda t: t[:-1]), ("nu_scale", lambda t: t[:, None])])
def test_load_state_dict_refuses_a_state_of_another_layout(key, bad):
    """A restored state must have the layout init_state makes (the kernel
    reads it through raw pointers): a saved state of another shape raises
    (the load casts the codes to int8 and the scales to f32)."""
    p = torch.zeros(1000, requires_grad=True)
    p.grad = torch.ones(1000)
    opt = o8.AdamW8bit([p])
    opt.step()
    saved = opt.state_dict()
    saved["state"][0][key] = bad(saved["state"][0][key])
    with pytest.raises(ValueError, match=key):
        o8.AdamW8bit([torch.zeros(1000, requires_grad=True)]
                     ).load_state_dict(saved)


def test_step_bf16_rounds_the_step_before_the_decay():
    """grads_bf16: the JAX step hands the 8-bit step back in the gradient's
    dtype (bf16), then adds the f32 decay."""
    p0 = torch.linspace(-1, 1, 300)
    g = torch.linspace(-3e-3, 5e-3, 300).bfloat16().float()
    state = o8.init_state(p0)
    h = o8.Adam8bitHyper(lr=1e-2, b1=0.9, b2=0.999, eps=1e-8,
                         weight_decay=1e-2, b1c=o8.bias_correction(0.9, 1),
                         b2c=o8.bias_correction(0.999, 1), step_bf16=True)
    p = p0.clone()
    o8.adam8bit_reference(p, g, state, h)
    tx = jax8.scale_by_adam_8bit()
    step, _ = tx.update(jnp.asarray(g.numpy()).astype(jnp.bfloat16),
                        tx.init(jnp.asarray(p0.numpy())))
    step = np.asarray(step.astype(jnp.float32))
    want = p0.numpy() + (-1e-2) * (step + 1e-2 * p0.numpy())
    np.testing.assert_allclose(p.numpy(), want, rtol=0, atol=1e-7)
    # the optimizer with step_bf16 (the train step sets it under
    # grads_bf16) takes the same update
    q = p0.clone().requires_grad_(True)
    q.grad = g.clone()
    o8.AdamW8bit([q], lr=1e-2, step_bf16=True).step()
    assert torch.equal(q.detach(), p)


def test_the_wrapper_runs_the_plain_version_on_the_cpu_and_counts_nothing():
    params, grads = _five_updates(steps=1)
    p = [torch.from_numpy(x.copy()) for x in params]
    q = [torch.from_numpy(x.copy()) for x in params]
    gs = [torch.from_numpy(x) for x in grads[0]]
    states_a = [o8.init_state(t) for t in p]
    states_b = [o8.init_state(t) for t in q]
    h = o8.Adam8bitHyper(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                         weight_decay=1e-2, b1c=o8.bias_correction(0.9, 1),
                         b2c=o8.bias_correction(0.999, 1))
    before = kernel.adam8bit_update.launches
    kernel.adam8bit_update(p, gs, states_a, h)
    for t, g, st in zip(q, gs, states_b):
        o8.adam8bit_reference(t, g, st, h)
    assert kernel.adam8bit_update.launches == before
    for a, b, sa, sb in zip(p, q, states_a, states_b):
        assert torch.equal(a, b)
        for k in o8.STATE_KEYS:
            assert torch.equal(sa[k], sb[k])
    with pytest.raises(ValueError, match="unsupported device"):
        kernel.adam8bit_update([torch.zeros(3, device="meta")],
                               [torch.zeros(3, device="meta")],
                               [o8.init_state(torch.zeros(3))], h)
