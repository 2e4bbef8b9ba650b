"""The 8-bit AdamW on several ranks on the CPU (gloo, one spawn of two
ranks): ZeRO-1 over dp=2, dp=2 against one process at the global batch,
and tp=2 against tp=1, each over two updates (``UPDATES``), so that the
second dequantizes the codes the first stored.

The weights are the port's tiny modules, seeded, and the batch two seeded
rows with their draws (``torch_parallel_workers.random_batch``); no JAX.

- ZeRO-1 shards the 8-bit state by whole tensors, and each tensor's update
  is the same arithmetic on the same all-reduced gradient: the parameters
  and the consolidated state equal replicated 8-bit AdamW bit for bit.
- dp=2 against one process: the gradients differ by the f32 summation
  order, which flips a code only where a moment sits at a code's
  boundary; the two updates are held at rel-L2 ``DP_UPDATE_TOL`` per group
  (1e-3, the tuning tests' update tolerance; 1.8e-4 measured, f32 AdamW
  5e-5 to 9.4e-5).
- tp=2: each rank keeps the 8-bit state of its own shard, so the blocks
  follow the shard and not the whole tensor (the JAX package keeps it
  unsharded): a row-split weight's shard is a set of columns, whose blocks
  take other absmax scales than the whole tensor's, so its codes round
  elsewhere. The UNet's two updates are held at rel-L2 ``TP_UPDATE_TOL``
  against tp=1 (3.4e-3 measured, against 3.4e-4 with f32 AdamW: the
  second update reads the shard's codes), the other groups (whole on
  every rank) at ``DP_UPDATE_TOL`` (2.5e-4 and 3.8e-4 measured).
"""
import pytest
import torch

from e4t_diffusion_torch.diffusion.pipeline import E4TModules
from e4t_diffusion_torch.models import weight_offsets as wo
from e4t_diffusion_torch.parallel import mesh as pmesh

import torch_parallel_workers as workers

LR = 1e-3
PRE_CFG = dict(domain_embed_scale=0.1, reg_lambda=0.01)
TUNE_CFG = dict(PRE_CFG, train_unet=True, max_grad_norm=1.0)
DP_UPDATE_TOL = 1e-3
TP_UPDATE_TOL = 1e-2
UPDATES = 2


@pytest.fixture(scope="module")
def payload():
    torch.manual_seed(0)
    modules = E4TModules.tiny(device="cpu")
    sds = {name: {k: v.clone() for k, v in mod.state_dict().items()}
           for name, mod in zip(("unet", "vae", "text", "e4t"),
                                modules.all())}
    sds["offsets"] = wo.init_offset_bank(modules.unet.config,
                                         torch.Generator().manual_seed(1))
    return {"sds": sds, "batch": workers.random_batch(5, 2), "lr": LR,
            "use_8bit": True, "updates": UPDATES}


@pytest.fixture(scope="module")
def world2(payload, tmp_path_factory):
    """One spawn of two ranks: pretraining at dp=2 replicated and under
    ZeRO-1, tuning at tp=2; and the one-process runs of both."""
    cases = [("dp", 1, False, PRE_CFG), ("zero1", 1, True, PRE_CFG),
             ("tp", 2, False, TUNE_CFG)]
    ranks = workers.run_ranks(workers.train_cases, 2,
                              dict(payload, cases=cases),
                              tmp_path_factory.mktemp("world2_8bit"))
    torch.set_num_threads(1)
    one = {name: workers.train_step(pmesh.Mesh(), payload, cfg)
           for name, cfg in (("pre", PRE_CFG), ("tune", TUNE_CFG))}
    return ranks, one


def _update_rel(got, want):
    keys = sorted(want["after"])
    start = torch.cat([want["before"][k].ravel() for k in keys]).double()
    a = torch.cat([got["after"][k].ravel() for k in keys]).double() - start
    b = torch.cat([want["after"][k].ravel() for k in keys]).double() - start
    assert float(b.abs().max()) > 0
    return float((a - b).norm() / b.norm())


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def test_zero1_8bit_equals_replicated_8bit_bit_for_bit(world2):
    ranks, _ = world2
    for rank in ranks:
        dp, z = rank["dp"], rank["zero1"]
        assert dp["metrics"] == z["metrics"]
        for g, tensors in dp["after"].items():
            for k, t in tensors.items():
                assert torch.equal(t, z["after"][g][k]), (g, k)
    # rank 0 holds the consolidated (unsharded) state
    sd, sz = ranks[0]["dp"]["optimizer"], ranks[0]["zero1"]["optimizer"]
    assert set(sd["state"]) == set(sz["state"])
    for i, st in sd["state"].items():
        assert set(st) == {"step", "mu_q", "mu_scale", "nu_q", "nu_scale"}
        for k, v in st.items():
            assert _same(v, sz["state"][i][k]), (i, k)
    assert sd["state"][0]["mu_q"].dtype == torch.int8


def test_dp2_8bit_matches_one_process(world2):
    ranks, one = world2
    for run in (*(rank["dp"] for rank in ranks), one["pre"]):
        for st in run["optimizer"]["state"].values():
            assert st["step"] == UPDATES
            assert st["mu_q"].dtype == st["nu_q"].dtype == torch.int8
    for rank in ranks:
        for k in ("loss", "loss_diff", "loss_reg", "grad_norm"):
            assert rank["dp"]["metrics"][k] == pytest.approx(
                one["pre"]["metrics"][k], rel=1e-5), k
        for group in one["pre"]["after"]:
            got = {"after": rank["dp"]["after"][group]}
            want = {"after": one["pre"]["after"][group],
                    "before": one["pre"]["before"][group]}
            assert _update_rel(got, want) <= DP_UPDATE_TOL, group


def test_tp2_8bit_keeps_each_shards_state_and_tracks_tp1(world2):
    ranks, one = world2
    for rank in ranks:
        tp = rank["tp"]
        # the blocks follow this rank's shards
        for i, n in enumerate(tp["numel"]):
            assert tp["optimizer"]["state"][i]["mu_q"].shape == (
                -(-n // 256), 256)
        assert sum(tp["numel"]) < sum(one["tune"]["numel"])
        for group in one["tune"]["after"]:
            got = {"after": tp["after"][group]}
            want = {"after": one["tune"]["after"][group],
                    "before": one["tune"]["before"][group]}
            tol = TP_UPDATE_TOL if group == "unet" else DP_UPDATE_TOL
            assert _update_rel(got, want) <= tol, group
    for group, tensors in ranks[0]["tp"]["after"].items():
        for k, t in tensors.items():
            assert torch.equal(t, ranks[1]["tp"]["after"][group][k]), k
