"""Analytic FLOP counts for the E4T components, for MFU accounting.

The port's own copy of ``e4t_diffusion_tpu/utils/flops.py``: the same
functions with the same integer results, reading the port's config
dataclasses (whose field names are the JAX package's). Counts multiply-add
as 2 FLOPs, matmul/conv only (norms, activations, softmax and elementwise
adds are bandwidth-bound and <1% of FLOPs at SD-v1 geometry). Held against
``torch.utils.flop_counter.FlopCounterMode`` on the einsum attention path
in ``tests/test_torch_flops.py``.

Peaks of one NVIDIA H100 SXM5 (the NVIDIA H100 Tensor Core GPU datasheet,
dense, without sparsity): 989 TFLOP/s bf16 on the tensor cores, 1,979
TOP/s int8 on the tensor cores, 67 TFLOP/s f32 on the CUDA cores (FFMA).
MFU = analytic_flops / wall_time / peak.
"""
from __future__ import annotations

H100_BF16_PEAK = 989e12
H100_INT8_PEAK = 1979e12
H100_F32_PEAK = 67e12


def conv2d(h, w, cin, cout, k=3, stride=1):
    return 2 * (h // stride) * (w // stride) * k * k * cin * cout


def dense(n, cin, cout):
    return 2 * n * cin * cout


def attention(n_q, n_kv, dim, heads=None):
    """QK^T + AV (projections counted separately): 2 * 2 * n_q*n_kv*dim."""
    del heads  # head split doesn't change the contraction FLOPs
    return 4 * n_q * n_kv * dim


def transformer_block(n, ctx_len, dim, ctx_dim, ff_mult=4, geglu=True):
    """One BasicTransformerBlock: self-attn + cross-attn + GEGLU FF."""
    f = 0
    # self-attention: q,k,v,out projections + attention
    f += 4 * dense(n, dim, dim) + attention(n, n, dim)
    # cross-attention: q from dim, k/v from ctx_dim
    f += dense(n, dim, dim) + 2 * dense(ctx_len, ctx_dim, dim)
    f += dense(n, dim, dim) + attention(n, ctx_len, dim)
    # FF: GEGLU proj is dim -> 2*4*dim, then 4*dim -> dim
    f += dense(n, dim, ff_mult * dim * (2 if geglu else 1))
    f += dense(n, ff_mult * dim, dim)
    return f


def resnet_block(h, w, cin, cout, temb):
    f = conv2d(h, w, cin, cout) + conv2d(h, w, cout, cout)
    f += dense(1, temb, cout)  # time projection
    if cin != cout:
        f += conv2d(h, w, cin, cout, k=1)
    return f


def tx2d(h, w, dim, ctx_len, ctx_dim, linear_proj=False):
    n = h * w
    k = 1
    f = 2 * (dense(n, dim, dim) if linear_proj else conv2d(h, w, dim, dim, k))
    f += transformer_block(n, ctx_len, dim, ctx_dim)
    return f


def unet_forward(cfg, latent_hw: int, ctx_len: int = 77,
                 encoder_half_only: bool = False) -> int:
    """Per-image forward FLOPs for models.unet.UNet2DConditionModel;
    ``encoder_half_only``: the down blocks and the mid block (what the E4T
    tap reads), without the up path."""
    chans = cfg.block_out_channels
    temb = chans[0] * 4
    hw = latent_hw
    f = conv2d(hw, hw, cfg.in_channels, chans[0])
    f += dense(1, chans[0], temb) + dense(1, temb, temb)

    out_c = chans[0]
    for bi, btype in enumerate(cfg.down_block_types):
        in_c, out_c = out_c, chans[bi]
        final = bi == len(chans) - 1
        cross = btype == "CrossAttnDownBlock2D"
        for j in range(cfg.layers_per_block):
            f += resnet_block(hw, hw, in_c if j == 0 else out_c, out_c, temb)
            if cross:
                f += tx2d(hw, hw, out_c, ctx_len, cfg.cross_attention_dim,
                          cfg.use_linear_projection)
        if not final:
            f += conv2d(hw, hw, out_c, out_c, stride=2)
            hw //= 2

    # mid
    f += resnet_block(hw, hw, chans[-1], chans[-1], temb) * 2
    f += tx2d(hw, hw, chans[-1], ctx_len, cfg.cross_attention_dim,
              cfg.use_linear_projection)
    if encoder_half_only:
        return f

    rev = list(reversed(chans))
    skip_ch = [chans[0]]
    for bi, _ in enumerate(cfg.down_block_types):
        skip_ch += [chans[bi]] * cfg.layers_per_block
        if bi != len(chans) - 1:
            skip_ch.append(chans[bi])
    prev_c = chans[-1]
    for bi, btype in enumerate(cfg.up_block_types):
        out_c = rev[bi]
        final = bi == len(chans) - 1
        cross = btype == "CrossAttnUpBlock2D"
        for j in range(cfg.layers_per_block + 1):
            skip = skip_ch.pop()
            f += resnet_block(hw, hw, (prev_c if j == 0 else out_c) + skip,
                              out_c, temb)
            if cross:
                f += tx2d(hw, hw, out_c, ctx_len, cfg.cross_attention_dim,
                          cfg.use_linear_projection)
        if not final:
            hw *= 2  # upsampler: 2x nearest resize, then 3x3 conv at the
            f += conv2d(hw, hw, out_c, out_c)  # POST-resize resolution
        prev_c = out_c
    f += conv2d(hw, hw, chans[0], cfg.out_channels)
    return f


def vit_forward(cfg, batch: int = 1) -> int:
    """models.vit VisionTransformer (CLIP vision tower) per-batch forward
    FLOPs."""
    n = cfg.num_tokens
    d, L = cfg.width, cfg.num_layers
    f = conv2d(cfg.grid, cfg.grid, 3 * cfg.patch_size * cfg.patch_size, d,
               k=1)  # patchify as matmul
    per_layer = (4 * dense(n, d, d) + attention(n, n, d)
                 + dense(n, d, cfg.mlp_dim) + dense(n, cfg.mlp_dim, d))
    return batch * (f + L * per_layer)


def text_encoder_forward(cfg, batch: int = 1) -> int:
    n, d, L = cfg.max_position_embeddings, cfg.hidden_size, cfg.num_layers
    per_layer = (4 * dense(n, d, d) + attention(n, n, d)
                 + dense(n, d, cfg.intermediate_size)
                 + dense(n, cfg.intermediate_size, d))
    return batch * L * per_layer


def vae_decode(cfg, latent_hw: int) -> int:
    """models.vae AutoencoderKL.decode per-image FLOPs (SD layout:
    post_quant conv, mid (2 resnets + 1 self-attn), reversed blocks of
    layers_per_block+1 resnets with upsamplers, conv_out)."""
    chans = cfg.block_out_channels
    hw = latent_hw
    c = chans[-1]
    f = conv2d(hw, hw, cfg.latent_channels, cfg.latent_channels, k=1)
    f += conv2d(hw, hw, cfg.latent_channels, c)
    # mid: resnet, attn (single-head self-attention at hw*hw), resnet
    f += 2 * 2 * conv2d(hw, hw, c, c)
    n = hw * hw
    f += 4 * dense(n, c, c) + attention(n, n, c)
    rev = list(reversed(chans))
    prev = c
    for bi, out_c in enumerate(rev):
        for j in range(cfg.layers_per_block + 1):
            cin = prev if j == 0 else out_c
            f += conv2d(hw, hw, cin, out_c) + conv2d(hw, hw, out_c, out_c)
            if cin != out_c:
                f += conv2d(hw, hw, cin, out_c, k=1)
        if bi != len(rev) - 1:
            hw *= 2
            f += conv2d(hw, hw, out_c, out_c)
        prev = out_c
    f += conv2d(hw, hw, chans[0], cfg.out_channels)
    return f
