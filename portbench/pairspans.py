"""The paired aligner's stages (`bowtie2_server_tpu_torch/align/paired.py`:
`pe.rescue` and `pe.decide`, inside each pair batch's `pe.wait`) for the
readers of the `paired.*_ms_per_kread` metrics."""
from __future__ import annotations

from .spans import named


def stage_ms_per_kmate(trace, ctx, stage: str):
    """The seconds of the `stage` spans that lie inside a `pe.wait` span
    (on its thread) as ms a thousand of the mates those `pe.wait` spans
    count, over the `pe.wait` spans that started and ended in the traced
    slice; a batch without the stage adds its mates and no time. None
    without a `pe.wait` span: a program without the spans."""
    spans = named(trace, ctx, "pe.wait", stage)
    waits = [s for s in spans if s.name == "pe.wait"]
    mates = sum(w.attrs["reads"] for w in waits)
    if not mates:
        return None
    inner = [s for s in spans if s.name == stage and any(
        w.thread == s.thread and w.t0 <= s.t0 and s.t1 <= w.t1
        for w in waits)]
    return sum(s.s for s in inner) * 1e3 / (mates / 1e3)
