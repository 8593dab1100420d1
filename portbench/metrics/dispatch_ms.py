"""Host layer: mean host ms a pair of the runner's ``dispatch`` stage
(the pair's upload and ``detect_step``'s launches), from
``PipelineRunner.timer``, over the window's pairs outside the traced
part."""

import statistics


def read(run, name):
    vals = run.stage_ms.get("dispatch") if run.kind == "serve" else None
    return statistics.fmean(vals) if vals else None
