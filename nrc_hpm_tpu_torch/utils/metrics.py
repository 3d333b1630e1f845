"""Structured run outputs: the reference's benchmark log + a JSONL stream.

Port of ``nrc_hpm_tpu/utils/metrics.py``, a copy, so the two apps write
the same files: one ``frame mse relBias cv`` line per benchmarked frame to
``<out>/log.txt`` (the reference's format) and one JSON record per frame
(frame time, loss, compare stats for both renderers) or event to
``<out>/metrics.jsonl``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class RunLogger:
    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        # LogFile recreates the file each run (LogFile.cpp:7-13)
        self._log = open(os.path.join(out_dir, "log.txt"), "w")
        self._jsonl = open(os.path.join(out_dir, "metrics.jsonl"), "w")
        self._t0 = time.time()

    def frame(self, frame_index: int, frame_time_ms: float,
              loss: Optional[float] = None,
              nrc_cmp=None, mc_cmp=None, **extra) -> None:
        if nrc_cmp is not None:
            # "frame mse relBias cv" (main.cu:145-149)
            self._log.write(
                f"{frame_index} {nrc_cmp.mse} {nrc_cmp.rel_bias} "
                f"{nrc_cmp.cv}\n")
            self._log.flush()
        rec = {"frame": frame_index, "t": round(time.time() - self._t0, 3),
               "frame_time_ms": round(frame_time_ms, 3)}
        if loss is not None:
            rec["loss"] = loss
        for name, cmp_ in (("nrc", nrc_cmp), ("mc", mc_cmp)):
            if cmp_ is not None:
                rec[name] = {"mse": cmp_.mse, "rel_bias": cmp_.rel_bias,
                             "rel_var": cmp_.rel_var, "cv": cmp_.cv,
                             "own_mean": cmp_.own_mean,
                             "ref_mean": cmp_.ref_mean}
        rec.update(extra)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def event(self, kind: str, **fields) -> None:
        """Write a non-frame record (e.g. the per-stage profile) to the
        JSONL stream."""
        rec = {"event": kind, "t": round(time.time() - self._t0, 3)}
        rec.update(fields)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self):
        self._log.close()
        self._jsonl.close()
