"""``to_host_share.explain``: the share of the traced window that the host
spends in the Explainer's ``lrpic.explain.to_host`` spans (the wait for a
chunk's queued work and the copies of its maps to the host), on the rank
where it is highest; None where no such span was recorded."""

SPAN = "lrpic.explain.to_host"


def read(ctx):
    shares = [100.0 * t.host_span_s(SPAN) / t.window_s for t in ctx["traces"]
              if SPAN in t.host_s and t.window_s > 0]
    return max(shares) if shares else None
