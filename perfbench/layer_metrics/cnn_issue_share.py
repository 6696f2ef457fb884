"""``cnn_issue_share.explain``: the share of the traced window that the host
spends in the Explainer's ``lrpic.explain.cnn`` spans (issuing the CNN side,
the per-image LRP walk), on the rank where it is highest; None where no
such span was recorded. Beside the CNN side's device time it says whether
the card waits on the host's issue."""

SPAN = "lrpic.explain.cnn"


def read(ctx):
    shares = [100.0 * t.host_span_s(SPAN) / t.window_s for t in ctx["traces"]
              if SPAN in t.host_s and t.window_s > 0]
    return max(shares) if shares else None
