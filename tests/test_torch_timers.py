"""The port's timing tools on the CPU at tiny sizes, CUDA events replaced by
the host's clock: ``time_components`` (every row, the MFU keys beside the
rows ``utils/flops.py`` counts, as ``scripts/bench_components.py`` maps
them), ``time_vit`` (every ablation, sharing the tower's weights) and
``time_loader`` (both transforms, one and two decode threads). Their
numbers here are no measurement: the tests hold the code paths and the
records' shape."""
import json
import statistics
import time

import pytest
import torch

from e4t_diffusion_torch import time_components as tc
from e4t_diffusion_torch import time_loader, time_vit
from e4t_diffusion_torch.diffusion.pipeline import E4TModules
from e4t_diffusion_torch.models import weight_offsets as wo
from e4t_diffusion_torch.models.vit import ViTConfig, VisionTransformer

# the rows scripts/bench_components.py:179-194 give an MFU
COUNTED = ("unet_fwd", "unet_fwd_int8", "unet_fwd_int8_static",
           "unet_fwd_with_tap", "text_encoder", "vit_encode",
           "vit_encode_int8", "vit_encode_int8_static", "vae_decode",
           "vae_decode_int8", "vae_decode_int8_static")


def _host_ms(fn, n):
    fn(0)
    times = []
    for i in range(n):
        t0 = time.perf_counter()
        fn(i)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


@pytest.fixture(autouse=True)
def _host_clock(monkeypatch):
    monkeypatch.setattr(tc, "events_ms", _host_ms)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # tiny models; the suite runs side by side
    yield
    torch.set_num_threads(threads)


def test_time_components_every_row():
    torch.manual_seed(0)
    modules = E4TModules.tiny(device="cpu")
    offsets = wo.init_offset_bank(modules.unet.config,
                                  torch.Generator().manual_seed(1))
    res = tc.time_components(modules, offsets, batch=2, resolution=32,
                             iters=1)
    for row in tc.ROWS:
        assert res[f"{row}_ms"] > 0, row
        assert res["calls"][row] == 2
    assert sorted(k[:-4] for k in res if k.endswith("_mfu")) == sorted(
        COUNTED)
    assert sorted(k[:-len("_int8_peak_share")] for k in res
                  if k.endswith("_int8_peak_share")) == sorted(
        r for r in COUNTED if "int8" in r)
    assert set(res["calib_calls"]) == {
        "unet_fwd_int8_static", "unet_fwd_int8_static_attn",
        "vit_encode_int8_static", "vae_decode_int8_static"}
    assert res["calib_calls"]["vit_encode_int8_static"] == 1
    assert res["calib_calls"]["vae_decode_int8_static"] == 0  # shared
    assert res["est_cfg_step_ms"] == pytest.approx(sum(
        res[f"{r}_ms"] for r in ("unet_fwd_with_tap", "unet_fwd",
                                 "text_encoder", "e4t_fuse")))
    json.dumps(res)
    flops = tc.row_flops(modules, 2, 32)
    assert res["unet_fwd_mfu"] == pytest.approx(
        flops["unet_fwd"] / (res["unet_fwd_ms"] * 1e-3) / 989e12)
    with pytest.raises(ValueError, match="no component row"):
        tc.time_components(modules, offsets, 2, 32, 2, rows=["unet"])


def test_time_vit_ablations_share_the_weights():
    torch.manual_seed(0)
    tower = VisionTransformer(ViTConfig.tiny()).eval().requires_grad_(False)
    res = time_vit.time_vit(tower, batch=2, iters=2)
    for row in time_vit.CONFIGS:
        assert res[f"{row}_ms"] > 0 and res[f"{row}_mfu"] > 0
        assert res["calls"][row] == 3
    for name, fields in time_vit.ABLATION_FIELDS.items():
        model = time_vit.ablated(tower, fields)
        ours = dict(model.named_parameters())
        for k, p in tower.named_parameters():
            if k in ours:
                assert ours[k].data_ptr() == p.data_ptr(), (name, k)
        x = torch.randn(1, 3, 28, 28)
        with torch.no_grad():
            same = torch.equal(model(x)[1], tower(x)[1])
        assert same == (name == "base"), name
    with pytest.raises(ValueError, match="no ViT ablation"):
        time_vit.time_vit(tower, 2, 1, ["flash"])


def test_time_loader_both_variants(tmp_path, capsys):
    records = time_loader.main([
        "--batches", "2", "--batch-size", "3", "--resolution", "32",
        "--source-px", "48", "--n-images", "8", "--workers", "0", "2"])
    assert [(r["variant"], r["workers"]) for r in records] == [
        ("native", 0), ("cv2", 0), ("native", 2), ("cv2", 2)]
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(line) for line in lines] == records
    for r in records:
        assert r["metric"] == "loader_images_per_sec"
        assert r["loader_images_per_sec"] > 0


def test_seeded_images_feed_the_pretraining_loader(tmp_path):
    """``seeded``'s written images and CLI arguments, which
    ``time_train_step --phase pretrain`` and ``chip_smoke.py`` share: mixed
    sizes and formats, nested, read by the CLI's own loader."""
    from e4t_diffusion_torch import pretrain_e4t, seeded

    data = tmp_path / "data"
    sizes = seeded.write_pretraining_images(str(data), 6)
    assert len(set(sizes)) == 6 and min(min(s) for s in sizes) >= 320
    names = sorted(p.name for p in data.rglob("*.*"))
    assert len(names) == 6 and {n[-3:] for n in names} == {"png", "jpg"}
    assert list((data / "nested").iterdir())
    args = seeded.pretrain_args(str(data), str(tmp_path / "out"),
                                "--max_train_steps", "2", batch=2,
                                resolution=32)
    assert (args.train_batch_size, args.resolution, args.max_train_steps,
            args.domain_class_token) == (2, 32, 2, "face")
    assert seeded.pretrain_args("d", "o").train_batch_size == 16
    loader, start = pretrain_e4t.make_loader(args)
    batch = next(iter(loader))
    assert start == 0 and batch["pixel_values"].shape == (2, 3, 32, 32)
