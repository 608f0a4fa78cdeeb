"""Training logs: the console and loss_log.txt line, and scalars.jsonl.

Port of the logging half of pix2pixhdaudiosr_tpu/utils/visualizer.py
(:29-69): the line `(epoch: %d, iters: %d, time: %.3f) name: %.3f ...`
(zero-valued losses skipped) and one JSON line of scalars a print. The
HTML gallery and --tf_log come with ROADMAP A8.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class Visualizer:
    def __init__(self, expr_dir: str):
        os.makedirs(expr_dir, exist_ok=True)
        self.log_name = os.path.join(expr_dir, "loss_log.txt")
        self.scalar_log = os.path.join(expr_dir, "scalars.jsonl")
        with open(self.log_name, "a") as f:
            f.write("================ Training Loss (%s) ================\n"
                    % time.strftime("%c"))

    def print_current_errors(self, epoch: int, i: int,
                             errors: Dict[str, float], t: float) -> None:
        message = "(epoch: %d, iters: %d, time: %.3f) " % (epoch, i, t)
        for k, v in errors.items():
            if v != 0:
                message += "%s: %.3f " % (k, v)
        print(message)
        with open(self.log_name, "a") as f:
            f.write("%s\n" % message)

    def plot_current_errors(self, errors: Dict[str, float], step: int) -> None:
        with open(self.scalar_log, "a") as f:
            f.write(json.dumps({"step": step, **errors}) + "\n")
