"""The port's forms of the JAX package's two stand-alone scripts:
``check_domain_class_token`` (the same stdout, message and exit code as
``scripts/check_domain_class_token.py`` on one tiny tokenizer directory)
and ``validate_real_weights`` (the chain on a tiny synthetic SD directory
with ``--device cpu``: staging, one tuning step, bf16 and static int8
sampling at 2 steps; the JAX script's flags and JSON keys)."""
import json
import os
import re
import runpy
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from e4t_diffusion_tpu.utils.tokenizer import make_tiny_tokenizer_files

from e4t_diffusion_torch import validate_real_weights
from e4t_diffusion_torch.utils import artifacts
from test_artifacts import _write_sd_base
from torch_parity import jax_tiny, port_tiny

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["photo", "of", "a", "the", "face", "in", "beach"]


@pytest.fixture(scope="module")
def tok_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tok"))
    make_tiny_tokenizer_files(d, extra_words=WORDS)
    return d


def _run(cmd, **env):
    """``python cmd`` from the root of the checkout, one thread a process
    (the tiny models gain nothing from more, and the suite runs workers
    side by side)."""
    return subprocess.run(
        [sys.executable, *cmd], cwd=REPO, capture_output=True, text=True,
        timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1",
                          "MKL_NUM_THREADS": "1", **env})


def _exit_code(main, capsys):
    """(exit code, stdout, stderr) of ``main()`` run in this process as the
    interpreter would run it: an uncaught AssertionError exits 1 with its
    message on stderr, ``sys.exit(msg)`` exits 1 with the message."""
    code = 0
    try:
        main()
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else 1
        if not isinstance(e.code, int):
            print(e.code, file=sys.stderr)
    except AssertionError as e:
        code = 1
        print(f"AssertionError: {e}", file=sys.stderr)
    out = capsys.readouterr()
    return code, out.out, out.err


# "face" is one entry of the tiny vocabulary; "ok" is two characters
@pytest.mark.parametrize("word,tokens", [("face", 1), ("ok", 2)])
def test_check_domain_class_token_as_jax(tok_dir, word, tokens, capsys,
                                         monkeypatch):
    """The port's module and the JAX script, each run as ``__main__``
    with the same arguments."""
    monkeypatch.setattr(sys, "argv", ["check", word, tok_dir])
    port = _exit_code(lambda: runpy.run_module(
        "e4t_diffusion_torch.check_domain_class_token", run_name="__main__"),
        capsys)
    ref = _exit_code(lambda: runpy.run_path(os.path.join(
        REPO, "scripts", "check_domain_class_token.py"),
        run_name="__main__"), capsys)
    assert port[0] == ref[0] == (0 if tokens == 1 else 1)
    assert port[1] == ref[1]
    if tokens == 1:
        assert port[1].startswith(f"ok: {word!r} -> token id ")
    else:
        message = (f"{word!r} is {tokens} tokens; choose a single-token "
                   f"class word")
        assert message in port[2] and message in ref[2]


def test_check_domain_class_token_usage():
    r = _run(["-m", "e4t_diffusion_torch.check_domain_class_token", "face"])
    assert r.returncode != 0 and "usage:" in r.stderr and not r.stdout


def _flags(source):
    return set(re.findall(r'add_argument\(\s*"(--\w+)"', source))


def _keys(source):
    return set(re.findall(r'out\["(\w+)"\]', source)) | {"metric", "prompt"}


def test_validate_real_weights_interface_matches_jax():
    with open(os.path.join(REPO, "scripts", "validate_real_weights.py")) as f:
        jax_source = f.read()
    with open(validate_real_weights.__file__) as f:
        port_source = f.read()
    assert _flags(port_source) == _flags(jax_source) | {"--device"}
    assert _keys(port_source) == _keys(jax_source)


def test_validation_chain_tiny(tmp_path):
    """The chain end to end on the CPU. The checkpoint's config names the
    hub id, which ``--sd_dir`` rewrites."""
    jm, params = jax_tiny(seed=2)
    sd_dir = _write_sd_base(str(tmp_path / "sd"), jm, params)
    make_tiny_tokenizer_files(os.path.join(sd_dir, "tokenizer"),
                              extra_words=WORDS)
    _, sds = port_tiny(params)
    ckpt_dir = artifacts.save_e4t_weights(
        str(tmp_path / "ckpt"), 100,
        {"placeholder_token": "*s", "domain_class_token": "face",
         "pretrained_model_name_or_path": "CompVis/stable-diffusion-v1-4",
         "vit_config": "tiny", "domain_embed_scale": 0.1,
         "clip_model_name_or_path": None, "unfreeze_clip_vision": False},
        sds["e4t"], None, sds["offsets"])
    domain = tmp_path / "domain.png"
    Image.fromarray(np.random.default_rng(0).integers(
        0, 255, (48, 48, 3), dtype=np.uint8)).save(domain)
    out_dir = str(tmp_path / "validation")
    r = _run(["-m", "e4t_diffusion_torch.validate_real_weights",
              "--e4t_ckpt", ckpt_dir, "--sd_dir", sd_dir,
              "--domain_image", str(domain),
              "--prompt", "a photo of *s in the beach",
              "--tune_steps", "1", "--num_inference_steps", "2",
              "--resolution", "32", "--train_batch_size", "2",
              "--seed", "0", "--out_dir", out_dir, "--device", "cpu"],
             E4T_INT8_CALIB_STEPS="2")
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    with open(os.path.join(out_dir, "validation.json")) as f:
        report = json.load(f)
    assert json.loads(r.stdout.strip().splitlines()[-1]) == report
    with open(validate_real_weights.__file__) as f:
        keys = _keys(f.read())
    assert set(report) == keys - {"clip_i_vs_domain", "clip_t",
                                  "clip_i_vs_reference_sample"}
    with open(os.path.join(report["staged_ckpt"], "config.json")) as f:
        assert json.load(f)["pretrained_model_name_or_path"] == sd_dir
    assert sorted(os.listdir(report["tuned_ckpt"]))[:2] == [
        "config.json", "domain.png"]
    for tag in ("bf16_sample", "int8_sample"):
        with Image.open(report[tag]) as img:
            assert img.size == (32, 32)
    delta = report["int8_vs_bf16"]
    assert np.isfinite(delta["rel_l2"]) and 0.0 <= delta["rel_l2"] < 1.0
    assert np.isfinite(delta["psnr_db"])
    assert report["clip_scores"].startswith("skipped")
