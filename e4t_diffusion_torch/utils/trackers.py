"""Experiment trackers: TensorBoard, wandb, or none.

The port's own copy of ``e4t_diffusion_tpu/utils/trackers.py``. The
training loop logs the scalars train/loss, train/loss_diff, train/loss_reg
and train/lr, the step timer's perf/* scalars, and the input and sample
image grids. tensorboardX and wandb are imported only when their tracker
is made; ``make_tracker`` falls back from wandb to TensorBoard when wandb
is not installed.
"""
from __future__ import annotations

import os
from typing import Dict, Optional


class NullTracker:
    def log(self, values: Dict, step: int) -> None:
        pass

    def log_images(self, images: Dict, step: int) -> None:
        pass

    def finish(self) -> None:
        pass


class TensorBoardTracker(NullTracker):
    def __init__(self, logging_dir: str, config: Optional[Dict] = None):
        from tensorboardX import SummaryWriter

        os.makedirs(logging_dir, exist_ok=True)
        self.writer = SummaryWriter(logging_dir)
        if config:
            self.writer.add_text("config", str(config), 0)

    def log(self, values: Dict, step: int) -> None:
        for k, v in values.items():
            self.writer.add_scalar(k, float(v), step)

    def log_images(self, images: Dict, step: int) -> None:
        import numpy as np

        for k, img in images.items():
            self.writer.add_image(k, np.asarray(img).transpose(2, 0, 1), step)

    def finish(self) -> None:
        self.writer.close()


class WandbTracker(NullTracker):
    def __init__(self, project: str, config: Optional[Dict] = None):
        import wandb

        self.wandb = wandb
        self.run = wandb.init(project=project, config=config)

    def log(self, values: Dict, step: int) -> None:
        self.wandb.log(values, step=step)

    def log_images(self, images: Dict, step: int) -> None:
        self.wandb.log({k: self.wandb.Image(v) for k, v in images.items()},
                       step=step)

    def finish(self) -> None:
        self.run.finish()


def make_tracker(report_to: Optional[str], logging_dir: str,
                 project: str = "e4t", config: Optional[Dict] = None,
                 is_main: bool = True) -> NullTracker:
    """The tracker ``--report_to`` names ("tensorboard" or "wandb"); a
    ``NullTracker`` for None, on every process but the main one, and where
    neither wandb nor tensorboardX is installed (the card's machine has
    neither)."""
    if not is_main or report_to is None:
        return NullTracker()
    if report_to == "wandb":
        try:
            return WandbTracker(project, config)
        except ImportError:
            print("[trackers] wandb unavailable; falling back to tensorboard")
            report_to = "tensorboard"
    if report_to == "tensorboard":
        try:
            return TensorBoardTracker(logging_dir, config)
        except ImportError:
            print("[trackers] tensorboardX unavailable; not logging (the "
                  "metrics are printed)")
            return NullTracker()
    raise ValueError(f"unknown tracker {report_to!r}")
