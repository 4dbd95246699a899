"""Real requests a dispatch over ``max_batch``, in %, over the window:
the server's own counters (``RenderServer.stats``)."""


def read(run):
    stats = run.facts.get("stats")
    if not stats or not stats.get("dispatches"):
        return None
    return (100.0 * stats["batched_requests"] / stats["dispatches"]
            / run.facts["max_batch"])
