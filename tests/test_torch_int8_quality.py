"""The port's int8 quality study (``python -m
e4t_diffusion_torch.int8_quality``) on the tiny configs on the CPU, and the
structured parameter fill it runs on."""
import math

import numpy as np
import pytest
import torch

from e4t_diffusion_torch import int8_quality
from e4t_diffusion_torch.models.vit import VisionTransformer, ViTConfig
from e4t_diffusion_torch.utils.structured_init import structured_fill_


def test_structured_fill_follows_the_names():
    torch.manual_seed(0)
    vit = VisionTransformer(ViTConfig(image_size=56, patch_size=14,
                                      width=64, num_layers=1, num_heads=4,
                                      mlp_dim=256))
    structured_fill_(vit, torch.Generator().manual_seed(1))
    params = dict(vit.named_parameters())
    assert torch.equal(params["ln_pre.weight"], torch.ones(64))
    assert torch.equal(params["ln_pre.bias"], torch.zeros(64))
    blk = "transformer.resblocks.0."
    assert torch.equal(params[blk + "attn.in_proj_bias"], torch.zeros(192))
    for name, fan_in in (("conv1.weight", 3 * 14 * 14),
                         (blk + "attn.in_proj_weight", 64),
                         (blk + "mlp.c_proj.weight", 256)):
        std = float(params[name].std()) * math.sqrt(fan_in)
        assert 0.9 < std < 1.1, (name, std)
    assert 0.015 < float(params["positional_embedding"].std()) < 0.025


@pytest.fixture(scope="module")
def results():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("E4T_QUAL_TINY", "1")
        mp.setenv("E4T_QUAL_STEPS", "3")
        mp.setenv("E4T_QUAL_CALIB_STEPS", "2")
        mp.setenv("E4T_QUAL_MODE",
                  "static,dynamic,static~conv_shortcut:upsamplers,"
                  "attn_qk,calib_gap")
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return int8_quality.main(["--device", "cpu"])
        finally:
            torch.set_num_threads(threads)


def test_study_reports_each_config(results):
    names = [r["metric"] for r in results]
    assert names == ["int8_static_vs_bf16_rel_l2_final",
                     "int8_dynamic_vs_bf16_rel_l2_final",
                     "int8_static~conv_shortcut:upsamplers_vs_bf16_rel_l2_"
                     "final", "int8_attn_qk_vs_bf16_rel_l2_final",
                     "int8_static_calib_gap"]
    for r in results[:3]:
        assert len(r["per_step_rel_l2"]) == 3
        assert 0 < r["value"] < r["anchor_unrelated_rel_l2"]
        assert np.isfinite([r["image_rel_l2"], r["image_psnr_db"]]).all()
        assert r["steps"] == 3 and r["device"] == "cpu"
        assert r.get("calib_steps") == (2 if "static" in r["metric"]
                                        else None)
    # the CPU has no flash-routed site: int8 attention changes nothing
    assert results[3]["value"] == 0.0
    gap = results[4]
    assert gap["n_sites"] > 0 and (gap["full_steps"], gap["calib_steps"]) \
        == (3, 2)
    ratios = [w["ratio"] for w in gap["worst"]]
    assert ratios == sorted(ratios, reverse=True) and min(ratios) > 0
    assert not any("." in w["site"] for w in gap["worst"])  # JAX paths
