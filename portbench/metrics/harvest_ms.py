"""Host layer: mean host ms a pair of the runner's ``harvest`` stage, the
blocking copy of a pair's results (the device draining behind it
included), from ``PipelineRunner.timer``, over the window's pairs outside
the traced part."""

import statistics


def read(run, name):
    vals = run.stage_ms.get("harvest") if run.kind == "serve" else None
    return statistics.fmean(vals) if vals else None
