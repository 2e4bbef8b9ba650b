"""The profiler helpers of ``chip_smoke.py`` and ``e4t_diffusion_torch/
timing.py`` when ``torch.profiler`` records no
device time, as it now and then does on the card's machine: on the CPU no
session holds a device record, so every session here is such a session.
``device_time`` must then time by CUDA events (stubbed here by the host's
clock) and say so, never return an empty session's zero; the int8 profile
must report its device numbers as not measured and still read the conv
sites' PyTorch ops off the host's records, which its check rests on.
"""
import time

import numpy as np
import pytest
import torch

import chip_smoke
from e4t_diffusion_torch import timing
from e4t_diffusion_torch.ops import quant


class _HostEvent:
    """``torch.cuda.Event`` on the host's clock."""

    def __init__(self, enable_timing=True):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


@pytest.fixture
def host_timers(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    # one fresh record, which timing.py's device_time and chip_smoke.py's
    # profiles both count into
    empty = dict.fromkeys(chip_smoke.PROFILER_EMPTY, 0)
    monkeypatch.setattr(chip_smoke, "PROFILER_EMPTY", empty)
    monkeypatch.setattr(timing, "PROFILER_EMPTY", empty)


def test_device_time_falls_back_to_events_after_three_empty_sessions(
        host_timers):
    calls = []
    x = torch.ones(64)

    def fn():
        calls.append(1)
        return x * 2

    ms, how = chip_smoke.device_time(fn, reps=4)
    assert how == "events_batch" and ms > 0
    # a warm-up, three profiled sessions and the timed batch
    assert len(calls) == 1 + 3 * 4 + 4
    assert chip_smoke.PROFILER_EMPTY["sessions"] == 3
    assert chip_smoke.PROFILER_EMPTY["events_fallbacks"] == 1
    assert chip_smoke.small_aware_ms(fn)[1] in ("events_batch", "events")


def test_profiles_without_a_device_record_measure_nothing(host_timers):
    x = torch.ones(4, 8)
    prof = chip_smoke._profile(lambda: x * 2)
    assert prof["device_busy_ms"] is None and prof["top"] == []
    assert prof["device_trace"] == "empty in three sessions"
    assert chip_smoke.PROFILER_EMPTY["sessions"] == 3


@pytest.mark.parametrize("mode", ["sa", "dynamic"])
def test_int8_profile_reads_conv_site_ops_off_the_host(host_timers, mode):
    """On the CPU a conv site runs its plain version, whose quantization is
    PyTorch ops: the check of ``phase_int8_sampling`` sees them with no
    device record at all."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 16, 8, 8)).astype(
        np.float32))
    site = {"q": torch.from_numpy(rng.integers(-127, 128, (16, 3, 3, 16),
                                               dtype=np.int8)),
            "s": torch.full((16,), 1e-2)}
    if mode == "sa":
        site["sa"] = x.abs().amax() / 127.0
    prof = chip_smoke._int8_profile(
        lambda: quant.int8_conv2d(x, site, None, 1, 1))
    assert prof["device_busy_ms"] is None and prof["split_ms"] is None
    assert prof["range_calls"]["conv_site"] == 1
    passes = set(prof["conv_site_op_names"]) & set(
        chip_smoke.CONV_QUANT_PASS_OPS)
    assert "aten::round" in passes


@pytest.mark.parametrize("argv, mode, profile, label", [
    ([], None, None, ""),
    (["--parallel"], "parallel", None, ""),
    (["--sd2"], "sd2", None, ""),
    (["--multi-card"], "multi-card", None, ""),
    (["--profile", "f32"], "profile", "f32", ""),
    (["--profile", "int8", "--label", "parent"], "profile", "int8",
     "parent")])
def test_chip_smoke_modes(argv, mode, profile, label):
    args = chip_smoke.parse_mode(argv)
    assert (args.mode, args.profile, args.label) == (mode, profile, label)


@pytest.mark.parametrize("argv", [
    ["--profile"], ["--profile", "bf16"], ["--label", "x"],
    ["--sd2", "--parallel"], ["--profile", "f32", "--sd2"], ["extra"]])
def test_chip_smoke_usage_errors(argv, capsys):
    with pytest.raises(SystemExit) as err:
        chip_smoke.parse_mode(argv)
    assert err.value.code == 2 and "usage: chip_smoke.py" in \
        capsys.readouterr().err
