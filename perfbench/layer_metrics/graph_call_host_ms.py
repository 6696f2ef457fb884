"""``graph_call_host_ms.<cell kind>``: the host's ms a step inside the
K-step calls of ``graphs.StepGraph`` (the ``lrpic.step_graph.call`` spans of
the traced calls over their steps), on the rank where it is highest; None
where no such span was recorded. About a ms where nothing in a call waits
on the card; near a step's device time where something does."""

SPAN = "lrpic.step_graph.call"


def read(ctx):
    t = ctx.get("traced")
    if not t or not t.get("steps"):
        return None
    ms = [1000.0 * s.host_span_s(SPAN) / t["steps"] for s in ctx["traces"] if SPAN in s.host_s]
    return max(ms) if ms else None
