"""Mean count of sealed segments a replica group holds, sampled once a
second through the window."""


def read(run):
    vals = run.samples.get("generations") or []
    if not run.mix.get("writes") or not vals:
        return None
    return sum(vals) / len(vals)
