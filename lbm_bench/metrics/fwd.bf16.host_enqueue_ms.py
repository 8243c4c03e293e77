"""The window glue in a bfloat16 forward window: ``fwd.host_enqueue_ms``
in the cells whose rate is held to a bound of its own (the span
``fwd.enqueue``). Moves ``mlups.bf16``."""


def read(run):
    spans = run.spans.get("fwd.enqueue")
    return spans[0] * 1e3 if spans else None
