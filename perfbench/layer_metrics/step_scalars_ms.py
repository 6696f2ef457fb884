"""``step_scalars_ms.<cell kind>``: the host's ms a step in the staging of
a ``StepGraph`` call's step scalars (the ``lrpic.step_graph.scalars`` spans:
Adam's scalars computed, pinned and copied to the card) over the traced
steps, on the rank where it is highest; None where no such span was
recorded."""

SPAN = "lrpic.step_graph.scalars"


def read(ctx):
    t = ctx.get("traced")
    if not t or not t.get("steps"):
        return None
    ms = [1000.0 * s.host_span_s(SPAN) / t["steps"] for s in ctx["traces"] if SPAN in s.host_s]
    return max(ms) if ms else None
