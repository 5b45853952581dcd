"""The window's time outside the trainer's steps (data wait, the feed and
the decision, Python between steps), in percent: 1 less the sum of the
steps' own times (the trainer's host clock around each step, ending in a
synchronise) over the window."""


def read(obs):
    if not obs.get("steps") or not obs.get("window_s"):
        return None
    return 100.0 * (1.0 - sum(obs["step_s"]) / obs["window_s"])
