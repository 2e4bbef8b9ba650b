"""Multi-node launches: the pretraining CLI as ``torchrun --nnodes 2
--nproc_per_node 2`` starts it (4 gloo ranks, ``LOCAL_RANK = RANK % 2``,
each rank joining the group from the environment through
``parallel/mesh.maybe_initialize_distributed``) against one node of 4
(``LOCAL_RANK = RANK``): one tiny step with a checkpoint, the same loss and
the same artifact bit for bit, and only global rank 0 writes anything (the
artifact, the checkpoint, the logs), as a shared ``--output_dir`` needs."""
import os

import numpy as np
import pytest
import torch
from PIL import Image

from e4t_diffusion_tpu.utils.tokenizer import make_tiny_tokenizer_files

import torch_parallel_workers as workers
from test_artifacts import _write_sd_base
from torch_parity import jax_tiny

WORDS = ["photo", "of", "a", "the", "face"]
WORLD = 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("multinode")
    jm, params = jax_tiny(seed=4)
    sd_dir = _write_sd_base(str(root / "sd"), jm, params)
    make_tiny_tokenizer_files(os.path.join(sd_dir, "tokenizer"),
                              extra_words=WORDS)
    os.makedirs(root / "data")
    rng = np.random.default_rng(1)
    for i in range(8):
        Image.fromarray(rng.integers(0, 255, (40, 36, 3), dtype=np.uint8)
                        ).save(root / "data" / f"{i}.png")
    argv = ["--pretrained_model_name_or_path", sd_dir,
            "--train_image_dataset", str(root / "data"),
            "--domain_class_token", "face", "--resolution", "32",
            "--train_batch_size", "1", "--learning_rate", "1e-3",
            "--report_to", "tensorboard", "--vit_config", "tiny",
            "--seed", "0", "--device", "cpu", "--max_train_steps", "1",
            "--checkpointing_steps", "1", "--n_save_sample", "0",
            "--local_rank", "7"]  # accepted and ignored
    templates = ["a photo of {placeholder_token}",
                 "a {placeholder_token} face"]
    out = {}
    for per_node in (2, WORLD):
        out[per_node] = workers.run_launched_ranks(
            workers.pretrain_cli, WORLD, per_node,
            {"argv": argv, "templates": templates,
             "root": str(root / f"nodes{WORLD // per_node}")},
            root / f"run{per_node}", timeout=150)
    return out


def test_ranks_take_their_local_rank_and_global_rank(runs):
    for per_node, ranks in runs.items():
        assert [r["rank"] for r in ranks] == list(range(WORLD))
        assert [r["local_rank"] for r in ranks] == [
            r % per_node for r in range(WORLD)]
        assert all(r["world"] == WORLD for r in ranks)


def test_only_global_rank_0_writes(runs):
    for ranks in runs.values():
        files = ranks[0]["files"]
        assert {"1/config.json", "1/encoder.pt", "1/weight_offsets.pt",
                "checkpoint-1/train_state.pt"} <= set(files)
        assert [f for f in files if f.startswith("logs/")]
        for r in ranks[1:]:
            assert r["files"] == [], (r["rank"], r["files"])


def test_two_nodes_equal_one_node_bit_for_bit(runs):
    two, one = runs[2], runs[WORLD]
    for a, b in zip(two, one):
        assert len(a["metrics"]) == 1
        assert a["metrics"] == b["metrics"]
        assert np.isfinite(a["metrics"][0]["loss"])
    for name in ("encoder.pt", "weight_offsets.pt"):
        x, y = two[0]["artifact"][name], one[0]["artifact"][name]
        assert sorted(x) == sorted(y)
        for k in x:
            assert torch.equal(x[k], y[k]), (name, k)
